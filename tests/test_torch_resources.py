"""Resource pools: avida_tpu_torch/ops/resources.py, the pools in
tasks.apply_reactions and the micro-step engine, and resource worlds,
against the reference's avida_tpu on the same inputs.

  * step_global / step_spatial / step_deme / step_gradient / consume /
    consume_deme on random pools over six decades (torus and grid
    stencils with 1-3 sub-steps, inflow boxes, moving and fixed peaks,
    contention, non-depletable and infinite processes, two reactions on
    one pool), against the compiled reference functions;
  * one engine cycle (TPU_USE_PALLAS=2) in which every organism collects
    fractional rewards from every pool kind at once, so every pool is
    contended and every float32 total shows its order;
  * a 12x12 world with global, spatial (torus and grid), gradient and
    deme pools and by-products on the micro-step engine in both packages,
    a few updates, the state field by field and resource.dat byte for
    byte.

Tolerance: exact -- float32 bit patterns equal.
"""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.environment import load_environment as rload  # noqa
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.ops import resources as rres  # noqa: E402
from avida_tpu.ops import tasks as rtasks  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.config import load_environment as tload  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.ops import resources as tres  # noqa: E402
from avida_tpu_torch.ops import tasks as ttasks  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_tasks import cpu_flags  # noqa: E402
from test_torch_world import (_assert_same_state,  # noqa: E402
                              _reseed_mixed)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the engine's many tiny operations run
    faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# every pool kind: three global (one not depleted), a torus and a grid
# spatial pool, a moving gradient, a deme pool; two reactions on glu and
# on grd, by-products into a global and a spatial pool
POOLS = """\
RESOURCE glu:inflow=10:outflow=0.05:initial=50
RESOURCE suc:inflow=3.3:outflow=0.013:initial=7.7
RESOURCE fix:inflow=1:outflow=0.0:initial=5
RESOURCE tor:geometry=torus:xdiffuse=1.0:ydiffuse=1.0:inflow=31.7:outflow=0.021:initial=0.3
RESOURCE grd:geometry=grid:xdiffuse=0.3:ydiffuse=0.45:inflowx1=1:inflowx2=3:inflowy1=-1:inflowy2=4:inflow=5.3:outflow=0.07
GRADIENT_RESOURCE hill:height=8:spread=3:plateau=2:updatestep=2:move_a_scaler=1.5
RESOURCE dpool:inflow=2.5:outflow=0.03:initial=40:demeresource=1
"""
WORLD_ENV = POOLS + """\
REACTION NOT1 not  process:value=1.0:type=pow:resource=glu:frac=0.0173
REACTION NOT2 not  process:value=0.5:type=pow:resource=tor:frac=0.3:product=suc:conversion=0.7
REACTION NOT3 not  process:value=0.25:type=pow:resource=grd:frac=0.5
REACTION NOT4 not  process:value=0.75:type=pow:resource=hill:frac=0.2
REACTION NOT5 not  process:value=0.6:type=pow:resource=dpool:frac=0.031
REACTION NAND nand process:value=1.0:type=pow:resource=glu:frac=0.11:product=tor:conversion=0.37
REACTION AND  and  process:value=2.0:type=pow:resource=suc:frac=0.25:max=2
REACTION ORN  orn  process:value=2.0:type=pow:resource=fix:depletable=0:frac=0.1
REACTION OR   or   process:value=3.0:type=pow:resource=grd:frac=0.4
REACTION EQU  equ  process:value=5.0:type=pow:resource=suc:frac=0.5
"""


def _write(tmp_path, env):
    p = tmp_path / "environment.cfg"
    p.write_text(env)
    return str(p)


def _params(tmp_path, vals, env=WORLD_ENV):
    path = _write(tmp_path, env)
    rcfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        rcfg.set(k, v)
    rp = rstate.make_world_params(rcfg, rconfig.default_instset(),
                                  rload(path))
    tp = tstate.make_world_params(convert.config_from_dict(vals),
                                  default_instset(), tload(path))
    return rp, tp


def _same(want, got):
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def _decades(rng, shape, lo=-3, hi=3):
    return (rng.random(shape) * 10.0 ** rng.integers(lo, hi, shape)).astype(
        np.float32)


VALS = dict(WORLD_X=12, WORLD_Y=12, NUM_DEMES=4)


@pytest.mark.parametrize("seed", range(3))
def test_step_global_and_deme_equal_reference(tmp_path, seed):
    """level + inflow - outflow * level with the product contracted into
    the subtract (as XLA's CPU backend compiles it), clamped at 0; deme
    pools (level + inflow) * (1 - outflow), not clamped."""
    rp, tp = _params(tmp_path, VALS)
    rng = np.random.default_rng(seed)
    f_g = jax.jit(lambda r: rres.step_global(rp, r))
    f_d = jax.jit(lambda d: rres.step_deme(rp, d))
    for _ in range(40):
        res = _decades(rng, 3)
        assert _same(f_g(res), tres.step_global(tp, torch.from_numpy(res)))
        d = (_decades(rng, (4, 1)) - rng.random((4, 1)) * 0.5).astype(
            np.float32)
        assert _same(f_d(d), tres.step_deme(tp, torch.from_numpy(d)))


# spatial pool sets covering the stencil's compiled forms: one pool or
# several (a scalar or a per-pool outflow factor), one geometry or mixed,
# one sub-step or more; the last is the gradient beside a torus
SPATIAL = {
    "torus-1x2": "RESOURCE a:geometry=torus:xdiffuse=1.0:ydiffuse=1.0:"
                 "inflow=31.7:outflow=0.021\n",
    "grid-1x1": "RESOURCE a:geometry=grid:xdiffuse=0.05:ydiffuse=0.6:"
                "inflow=31.7:outflow=0.021\n",
    "torus-1x1-box": "RESOURCE a:geometry=torus:xdiffuse=0.3:ydiffuse=0.2:"
                     "inflowx1=2:inflowx2=5:inflow=31.7:outflow=0.021\n",
    "grid-1x3": "RESOURCE a:geometry=grid:xdiffuse=1.5:ydiffuse=1.2:"
                "inflow=31.7:outflow=0.021\n",
    "torus-2x1": "RESOURCE a:geometry=torus:xdiffuse=0.3:ydiffuse=0.4:"
                 "inflow=31.7:outflow=0.021\n"
                 "RESOURCE b:geometry=torus:xdiffuse=0.1:ydiffuse=0.2:"
                 "inflow=3:outflow=0.1\n",
    "grid-2x1": "RESOURCE a:geometry=grid:xdiffuse=0.3:ydiffuse=0.4:"
                "inflow=31.7:outflow=0.021\n"
                "RESOURCE b:geometry=grid:xdiffuse=0.1:ydiffuse=0.2:"
                "inflow=3:outflow=0.1\n",
    "mixed-2x1": "RESOURCE a:geometry=torus:xdiffuse=0.3:ydiffuse=0.3:"
                 "inflow=31.7:outflow=0.021\n"
                 "RESOURCE b:geometry=grid:xdiffuse=0.1:ydiffuse=0.2:"
                 "inflowx1=1:inflowx2=3:inflowy1=-1:inflowy2=4:inflow=3\n",
    "torus-gradient": "RESOURCE a:geometry=torus:xdiffuse=1.0:ydiffuse=1.0:"
                      "inflow=31.7:outflow=0.021\n"
                      "GRADIENT_RESOURCE h:height=8:spread=3:plateau=2:"
                      "updatestep=2:move_a_scaler=1.5\n",
}


def _empty_pair(tmp_path, env, seed):
    """Both packages' worlds (micro-step engine, 10x7) with every cell
    empty and random spatial pool levels over three decades: an update
    is the resource phase alone, compiled inside the reference's update
    program."""
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "environment.cfg").write_text(
        env + "REACTION NOT not process:value=1.0:type=pow:resource=a\n")
    (cdir / "avida.cfg").write_text("")
    ov = list(dict(WORLD_X=10, WORLD_Y=7, RANDOM_SEED=seed,
                   TPU_USE_PALLAS=2, TPU_SYSTEMATICS=0, TPU_KERNEL_SHARDS=1,
                   TPU_COMPILE_CACHE=0).items())
    ref = RefWorld(config_dir=str(cdir), overrides=ov,
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=str(cdir), overrides=ov,
                 data_dir=str(tmp_path / "port"), device="cpu")
    ref.events, port.events = [], []
    port.inject()
    a = convert.state_to_arrays(port.state)
    a["alive"][:] = False
    a["res_grid"][:] = _decades(np.random.default_rng(seed),
                                a["res_grid"].shape, -2, 1)
    port.state = convert.state_from_arrays(a)
    ref.state = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in a.items()})
    return ref, port


@pytest.mark.parametrize("pools", sorted(SPATIAL))
def test_step_spatial_in_the_update_equals_reference(tmp_path, pools):
    """The inflow box (per-axis defaults), the outflow, and ceil(max(xd +
    yd)) stencil sub-steps, wrapped on a torus and zero-flux on a grid,
    as the reference's update program compiles them (the contraction of
    each product into its add, ops/resources.step_spatial): three updates
    of an empty world from random levels, res_grid exact after each."""
    ref, port = _empty_pair(tmp_path, SPATIAL[pools], 4)
    for u in range(1, 4):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        assert _same(ref.state.res_grid, port.state.res_grid), u
        assert _same(ref.state.grad_peak, port.state.grad_peak), u


@pytest.mark.parametrize("grad", [
    "height=8:spread=3:plateau=2:updatestep=2:move_a_scaler=1.5",
    "height=5.5:spread=6:plateau=-1:updatestep=1:peakx=3:peaky=9:"
    "move_a_scaler=2",
    "height=3:spread=2"])
def test_step_gradient_equals_reference(tmp_path, grad):
    """The cone, its plateau and spread, the peak's placement (configured
    or drawn) and its moves every `updatestep` updates, over 12 updates
    with the reference's fold_in / split / randint draws."""
    env = (f"GRADIENT_RESOURCE hill:{grad}\n"
           "REACTION NOT not process:value=1.0:type=pow:resource=hill\n")
    rp, tp = _params(tmp_path, dict(WORLD_X=12, WORLD_Y=11), env)
    g0 = np.arange(30, dtype=np.int8) % 26
    st_r = rstate.init_population(rp, g0, jax.random.key(3))
    st_t = tstate.init_population(tp, g0, prng.key(3))
    step = jax.jit(lambda s, k, u: rres.step_gradient(rp, s, k, u))
    peaks = []
    for u in range(1, 13):
        k = jax.random.key_data(jax.random.fold_in(jax.random.key(9), u))
        st_r = step(st_r, jax.random.wrap_key_data(k), u)
        st_t = tres.step_gradient(tp, st_t, convert.key_from_data(k), u)
        assert _same(st_r.res_grid, st_t.res_grid), u
        assert _same(st_r.grad_peak, st_t.grad_peak), u
        peaks.append(tuple(st_t.grad_peak[0].tolist()))
    moves = "move_a_scaler" in grad
    assert (len(set(peaks)) > 1) == moves
    if "peakx" in grad:
        assert peaks[0] != (-1, -1)


@pytest.mark.parametrize("seed", range(4))
def test_consume_equals_reference(tmp_path, seed):
    """Global pools with proportional scaling under contention (two
    reactions on glu), per-cell scaling on spatial pools, a
    non-depletable and an infinite process, and the deme pools' band
    contention, on random pools and reward masks of every density."""
    rp, tp = _params(tmp_path, VALS)
    tabs = rtasks.env_tables_to_device(rp)
    n, NR = tp.num_cells, tp.num_reactions
    f = jax.jit(lambda rw, r, g: rres.consume(rp, tabs, rw, 1.0, r, g))
    f_d = jax.jit(lambda rw, d: rres.consume_deme(rp, tabs, rw, d))
    rng = np.random.default_rng(seed)
    scaled = 0
    for _ in range(12):
        rew = rng.random((n, NR)) < rng.random()
        res = _decades(rng, 3, -1, 3)
        grid = _decades(rng, (3, n), -3, 2)
        # deme pools from empty to ample, so some bands run dry
        dres = (rng.random((4, 1)) * 10.0 ** rng.integers(-2, 2, (4, 1))
                ).astype(np.float32)
        want = f(rew, res, grid)
        got = tres.consume(tp, torch.from_numpy(rew), 1.0,
                           torch.from_numpy(res), torch.from_numpy(grid))
        for w, g in zip(want, got):
            assert _same(w, g)
        want = f_d(rew, dres)
        got = tres.consume_deme(tp, torch.from_numpy(rew),
                                torch.from_numpy(dres))
        for w, g in zip(want, got):
            assert _same(w, g)
        scaled += int((np.asarray(want[1]) == 0).sum())
    assert scaled > 0               # some deme pools were drawn to zero


# ---- one engine cycle: every organism rewarded from every pool ----

def _cycle_env(rng, infinite=False):
    """math_1AJ (|x|) reactions, each organism outputting a copy of its
    positive input performs all of them at once: fractional values of
    every process type on every pool kind, two on glu, grd and dpool,
    by-products into suc and tor; `infinite` appends an add process
    bound to no pool."""
    spec = [("glu", "pow"), ("glu", "mult"), ("suc", "add"),
            ("fix", "pow"), ("tor", "mult"), ("grd", "add"),
            ("grd", "pow"), ("hill", "mult"), ("dpool", "add"),
            ("dpool", "pow")] + ([(None, "add")] if infinite else [])
    lines = []
    for r, (res, t) in enumerate(spec):
        v = {"mult": 1 + rng.uniform(0.001, 0.9),
             "pow": rng.uniform(0.05, 0.95),
             "add": rng.uniform(0.5, 3.0)}[t]
        line = (f"REACTION R{r} math_1AJ process:value="
                f"{float(np.float32(v))!r}:type={t}")
        if res is not None:
            line += (f":resource={res}:frac="
                     f"{float(np.float32(rng.uniform(0.01, 0.6)))!r}")
        if r == 1:
            line += ":product=suc:conversion=0.7"
        if r == 5:
            line += ":product=tor:conversion=0.37"
        lines.append(line)
    return POOLS + "\n".join(lines) + "\n"


def _cycle_case(tmp_path, seed, infinite=False):
    """One cycle of each package's micro-step engine on the same 12x12
    state: every organism's first instruction is IO of a copy of its
    positive input, inside the requisite window of a random 70% of the
    reactions; random pool levels."""
    from avida_tpu.ops import update as rupd

    from avida_tpu_torch.ops import update as tupd
    rng = np.random.default_rng(seed)
    (tmp_path / "environment.cfg").write_text(_cycle_env(rng, infinite))
    (tmp_path / "avida.cfg").write_text("")
    ov = [("WORLD_X", 12), ("WORLD_Y", 12), ("TPU_USE_PALLAS", 2),
          ("TPU_SYSTEMATICS", 0), ("TPU_KERNEL_SHARDS", 1),
          ("TPU_COMPILE_CACHE", 0), ("RANDOM_SEED", seed),
          ("NUM_DEMES", 4)]
    ref = RefWorld(config_dir=str(tmp_path), overrides=ov,
                   data_dir=str(tmp_path / "r"))
    port = World(config_dir=str(tmp_path), overrides=ov,
                 data_dir=str(tmp_path / "p"), device="cpu")
    port.process_events()
    port._action_InjectAll([])
    st = {k: (None if v is None else v.copy())
          for k, v in convert.state_to_arrays(port.state).items()}
    n, R = st["tape"].shape[0], port.params.num_reactions
    a = rng.integers(1 << 20, 1 << 30, n).astype(np.int32)
    st["tape"][:, 0] = port.instset.inst_names.index("IO")
    st["heads"][:] = 0
    st["regs"][:] = a[:, None]
    st["input_buf"][:] = 0
    st["input_buf"][:, 0] = a
    st["input_buf_n"][:] = 1
    st["cur_task_count"][:] = np.where(rng.random((n, R)) < 0.7, 0, 2**30)
    st["cur_bonus"][:] = rng.uniform(0.5, 4.0, n).astype(np.float32)
    st["resources"][:] = _decades(rng, 3, 0, 2)
    st["res_grid"][:] = _decades(rng, st["res_grid"].shape, -2, 1)
    st["deme_resources"][:] = _decades(rng, (4, 1), 0, 2)
    granted = np.ones(n, np.int32)
    key = jax.random.key(seed)
    r_in = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in st.items()})
    r_out = jax.jit(lambda s, g: rupd.interpret_phase(
        ref.params, s, key, g, jnp.int32(1), 0)[0])(r_in, granted)
    t_out = tupd.interpret_phase(
        port.params, convert.state_from_arrays(st),
        convert.key_from_data(jax.random.key_data(key)),
        torch.from_numpy(granted), 0, max_k=1)
    return r_out, t_out, st


@pytest.mark.parametrize("seed", [1, 2])
def test_engine_cycle_with_every_pool_equals_reference(tmp_path, seed):
    """apply_reactions in the micro-step engine's context: each pool's
    demand and draw totals over 144 organisms (and over each 36-cell
    deme band), per-cell spatial scaling, the by-products' totals, and
    the bonus of value x amount -- every field exact after the cycle,
    with pools drawn down and scaled."""
    r_out, t_out, st = _cycle_case(tmp_path, seed)
    got = convert.state_to_arrays(t_out)
    for k in rstate.state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), k
    assert (got["resources"] != st["resources"]).all()
    assert (got["deme_resources"] != st["deme_resources"]).all()
    assert (got["cur_reaction_count"] > 0).sum() > 200


def _port_params(tmp_path):
    """The params of _cycle_case's port world."""
    return World(config_dir=str(tmp_path), overrides=[
        ("WORLD_X", 12), ("WORLD_Y", 12), ("TPU_USE_PALLAS", 2),
        ("TPU_SYSTEMATICS", 0), ("NUM_DEMES", 4)],
        data_dir=str(tmp_path / "p3"), device="cpu").params


def test_engine_cycle_with_an_unbound_process_beside_pools(tmp_path):
    """Pool-bound processes beside one bound to no pool: the reference's
    compiled IO block reduces the bonus's products and sum as one tree
    over the reactions padded to a power of two (tasks.vector_chunks'
    TREE), not in order; cur_bonus exact."""
    r_out, t_out, _ = _cycle_case(tmp_path, 1, infinite=True)
    assert _same(r_out.cur_bonus, t_out.cur_bonus)
    assert ttasks.vector_chunks(_port_params(tmp_path)) == {
        "pow": ttasks.TREE, "mult": ttasks.TREE, "add": ttasks.TREE}


# (resource, process type) of each reaction of _mixed_env's compositions:
# an unbound process first, two last, and 17 reactions (the 17th after
# the tree); at most two reactions on one pool
_BASE10 = [("glu", "pow"), ("glu", "mult"), ("suc", "add"), ("fix", "pow"),
           ("tor", "mult"), ("grd", "add"), ("grd", "pow"),
           ("hill", "mult"), ("dpool", "add"), ("dpool", "pow")]
_MIXED = {
    "first": [(None, "add")] + _BASE10,
    "two": _BASE10 + [(None, "add"), (None, "pow")],
    "r17": _BASE10 + [(None, "add"), ("suc", "pow"), ("fix", "mult"),
                      ("tor", "add"), ("hill", "pow"), (None, "mult"),
                      (None, "pow")],
}


def _mixed_env(spec):
    def env(rng, infinite=False):
        lines = []
        for r, (res, t) in enumerate(spec):
            v = {"mult": 1 + rng.uniform(0.001, 0.9),
                 "pow": rng.uniform(0.05, 0.95),
                 "add": rng.uniform(0.5, 3.0)}[t]
            line = (f"REACTION R{r} math_1AJ process:value="
                    f"{float(np.float32(v))!r}:type={t}")
            if res is not None:
                line += (f":resource={res}:frac="
                         f"{float(np.float32(rng.uniform(0.01, 0.6)))!r}")
            lines.append(line)
        return POOLS + "\n".join(lines) + "\n"
    return env


@pytest.mark.parametrize("case", sorted(_MIXED))
def test_engine_cycle_with_unbound_processes_reduces_as_a_tree(
        tmp_path, case, monkeypatch):
    """The tree form holds wherever the unbound processes sit, with two of
    them, and at 17 reactions (the 17th folded after the tree)."""
    monkeypatch.setattr(sys.modules[__name__], "_cycle_env",
                        _mixed_env(_MIXED[case]))
    r_out, t_out, _ = _cycle_case(tmp_path, 2)
    got = convert.state_to_arrays(t_out)
    for k in rstate.state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), k
    tables = ttasks.env_tables_to_device(_port_params(tmp_path),
                                         torch.device("cpu"))
    assert tables["chunks"]["add"] == ttasks.TREE


def test_pools_stay_put_in_a_cycle_without_io(tmp_path):
    """The reference runs the IO block under lax.cond(io_m.any()); a
    cycle in which no organism does IO leaves every pool bit-identical,
    -0.0 and negative deme levels included."""
    from avida_tpu_torch.ops import update as tupd
    _, _, st = _cycle_case(tmp_path, 3)
    st["tape"][:, 0] = 0                     # nop-A: no IO anywhere
    st["resources"][0] = -0.0
    st["deme_resources"][:, 0] = [-1.5, -0.0, 2.0, 0.0]
    st["res_grid"][0, :5] = -0.0
    port = World(config_dir=str(tmp_path), overrides=[
        ("WORLD_X", 12), ("WORLD_Y", 12), ("TPU_USE_PALLAS", 2),
        ("TPU_SYSTEMATICS", 0), ("NUM_DEMES", 4)],
        data_dir=str(tmp_path / "p2"), device="cpu")
    t_out = tupd.interpret_phase(
        port.params, convert.state_from_arrays(st), prng.key(1),
        torch.ones(len(st["alive"]), dtype=torch.int32), 0, max_k=1)
    for k in ("resources", "res_grid", "deme_resources"):
        assert getattr(t_out, k).numpy().tobytes() == st[k].tobytes(), k


# ---- a resource world on the micro-step engine ----

def _resource_pair(tmp_path, vals, env=WORLD_ENV, events=()):
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "environment.cfg").write_text(env)
    (cdir / "avida.cfg").write_text("")
    ov = list(vals.items())
    ref = RefWorld(config_dir=str(cdir), overrides=ov,
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=str(cdir), overrides=ov,
                 data_dir=str(tmp_path / "port"), device="cpu")
    evs = ["u begin InjectAll", "u 0:1:end PrintResourceData",
           "u 0:1:end PrintAverageData"] + list(events)
    ref.events = [parse_event_line(e) for e in evs]
    port.events = []
    for e in evs:
        port.add_event(e)
    return ref, port


def _assert_same_dat(tmp_path, name):
    a = (tmp_path / "ref" / f"{name}.dat").read_text().splitlines()
    b = (tmp_path / "port" / f"{name}.dat").read_text().splitlines()
    assert len(a) == len(b) > 8
    assert a[:1] + a[2:] == b[:1] + b[2:]       # line 2: the date


WORLD_VALS = dict(WORLD_X=12, WORLD_Y=12, RANDOM_SEED=5, AVE_TIME_SLICE=30,
                  TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0,
                  TPU_SYSTEMATICS=0, TPU_USE_PALLAS=2, NUM_DEMES=4)


def test_resource_world_equals_reference(tmp_path):
    """Every pool kind and two by-products on the micro-step engine in
    both packages: six updates from a mixed seeding, the state field by
    field after each, resource.dat and average.dat byte for byte, a
    SetResource between updates; no kernel launch."""
    ref, port = _resource_pair(tmp_path, WORLD_VALS,
                               events=["u 3 SetResource glu 80.5",
                                       "u 4 SetResource tor 1000"])
    rep = port.engine_report()
    assert rep["engine"] == "per-update" and "kernel off" in \
        rep["fallback_reason"]
    _reseed_mixed(ref, port)
    tpc.reset_launches()
    glu = []
    for u in range(1, 7):
        ref.run(max_updates=u)
        port.run(max_updates=u)
        _assert_same_state(ref, port, u)
        glu.append(float(port.state.resources[0]))
    assert tpc.LAUNCHES == 0
    _assert_same_dat(tmp_path, "resource")
    _assert_same_dat(tmp_path, "average")
    assert glu[2] != glu[3]                    # SetResource at update 3
    assert float(port.state.res_grid[0].sum()) > 500
    dres = port.state.deme_resources[:, 0].numpy()
    assert len(set(dres.tolist())) > 1         # demes drew differently


# ---- ROADMAP Queue 3: the compositions the port does not model ----

_R21 = _BASE10 + [(None, "add"), ("suc", "pow"), ("fix", "mult"),
                  ("tor", "add"), ("hill", "pow"), (None, "mult"),
                  (None, "pow"), ("suc", "mult"), ("fix", "add"),
                  ("tor", "pow"), (None, "add")]
_GRD3 = _BASE10 + [("grd", "mult"), (None, "add")]


def test_engine_cycle_pools_beside_unbound_21_reactions(tmp_path,
                                                       monkeypatch):
    """The second Queue 3 fault, repaired to 23 reactions: 21 reactions,
    pool-bound ones beside four bound to no pool.  The compiled IO block
    keeps the tree over the first 16 reactions with the rest in order
    (TREE) past 17; every field equal after one engine cycle."""
    monkeypatch.setattr(sys.modules[__name__], "_cycle_env",
                        _mixed_env(_R21))
    r_out, t_out, _ = _cycle_case(tmp_path, 2)
    got = convert.state_to_arrays(t_out)
    for k in rstate.state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), k
    assert ttasks.vector_chunks(_port_params(tmp_path)) == {
        "pow": ttasks.TREE, "mult": ttasks.TREE, "add": ttasks.TREE}


_R28 = _R21 + [("hill", "mult"), ("glu", "add"), ("dpool", "mult"),
               (None, "pow"), ("suc", "add"), ("fix", "pow"),
               ("tor", "mult")]
_R32 = _R28 + [(None, "add"), ("grd", "mult"), ("suc", "pow"),
               (None, "mult")]


@pytest.mark.parametrize("R,seed", [(24, 2), (28, 1), (32, 1)])
def test_engine_cycle_pools_beside_unbound_past_23_reactions(
        tmp_path, monkeypatch, R, seed):
    """The second Queue 3 fault, repaired from 24 reactions (read off the
    reference's dumped update program, the IO block's LLVM IR and its
    dot): 24, 28 and 32 reactions, pool-bound ones beside four to seven
    bound to no pool.  The bonus's products and sum fold 8-lane chunks
    into one accumulator, a lane tree, the rest in order
    (tasks.one_acc); the spatial demand and draw leave the fused loop
    for a dot that sums in 4-lane vectors (resources.DOT4).  Every field
    equal after one engine cycle."""
    monkeypatch.setattr(sys.modules[__name__], "_cycle_env",
                        _mixed_env(_R32[:R]))
    r_out, t_out, _ = _cycle_case(tmp_path, seed)
    got = convert.state_to_arrays(t_out)
    for k in rstate.state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), \
            (k, cpu_flags())
    assert ttasks.vector_chunks(_port_params(tmp_path)) == {
        k: ttasks.one_acc(R // 8) for k in ("pow", "mult", "add")}


@pytest.mark.parametrize("seed", [1, 2])
def test_engine_cycle_three_reactions_on_one_spatial_pool(tmp_path,
                                                          monkeypatch, seed):
    """The third Queue 3 fault (fixed): `grd` bound by three reactions
    beside one unbound add process, 12x12.  The compiled consume sums each
    cell's spatial demand and draw over the reactions as the IO block's
    tree (tasks.vector_fold's TREE) in this composition; every field,
    res_grid included, equal after one engine cycle."""
    monkeypatch.setattr(sys.modules[__name__], "_cycle_env",
                        _mixed_env(_GRD3))
    r_out, t_out, st = _cycle_case(tmp_path, seed)
    got = convert.state_to_arrays(t_out)
    for k in rstate.state_field_names():
        if getattr(r_out, k) is None:
            continue
        assert np.asarray(getattr(r_out, k)).tobytes() == got[k].tobytes(), k
    assert (got["res_grid"] != st["res_grid"]).any()
