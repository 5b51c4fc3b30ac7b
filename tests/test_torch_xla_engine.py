"""The micro-step cycle engine in a world: the port's World.run against
the reference's with the same configuration, seed and state, update by
update.

  * TPU_USE_PALLAS=2 in both packages, systematics off and on, from an
    evolved 8x8 state (births every update), .dat files included;
  * a logic-9 + math-family environment with fractional values under
    TPU_USE_PALLAS=0 in both packages: the kernel gate refuses math tasks,
    so both route to their micro-step (XLA) engine;
  * the port's two engines against each other on the reference's
    cross-engine configuration (tests/test_pallas.py: mutations off,
    SLICING_METHOD 0): the kernel's plain version and the micro-step
    engine agree on every field but the lane permutation;
  * the batched fold: tests/test_torch_xla_batch.py.

The reference world runs its XLA engine on the CPU, the port its engines'
plain PyTorch versions.

Tolerance: exact -- every state field byte for byte at every update, .dat
files byte-identical apart from the header's date line.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu import config as rconfig  # noqa: E402
from avida_tpu.config.events import parse_event_line  # noqa: E402
from avida_tpu.core import state as rstate  # noqa: E402
from avida_tpu.world import World as RefWorld  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.core import state as tstate  # noqa: E402
from avida_tpu_torch.ops import cycles as tpc  # noqa: E402
from avida_tpu_torch.world import World  # noqa: E402

from test_torch_world import (DATS, _assert_same_dats,  # noqa: E402
                              _assert_same_state, _reseed_mixed,
                              _reseed_port)

VALS = dict(WORLD_X=8, WORLD_Y=8, RANDOM_SEED=3, AVE_TIME_SLICE=30,
            TPU_KERNEL_SHARDS=1, TPU_COMPILE_CACHE=0)
EVOLVE = 24
# logic-9 plus math-family reactions with fractional values; an output
# that repeats an input performs math_1AJ (|x|) and, for the smaller of
# two positive inputs, math_2AC (x % y): up to three fractional rewards
# of one process type in one cycle
MATH_ENV = """\
REACTION NOT  not  process:value=1.0:type=pow requisite:max_count=1
REACTION NAND nand process:value=1.0:type=pow requisite:max_count=1
REACTION AND  and  process:value=2.0:type=pow requisite:max_count=1
REACTION ORN  orn  process:value=2.0:type=pow requisite:max_count=1
REACTION OR   or   process:value=3.0:type=pow requisite:max_count=1
REACTION ANDN andn process:value=3.0:type=pow requisite:max_count=1
REACTION NOR  nor  process:value=4.0:type=pow requisite:max_count=1
REACTION XOR  xor  process:value=4.0:type=pow requisite:max_count=1
REACTION EQU  equ  process:value=5.0:type=pow requisite:max_count=1
REACTION ABS1 math_1AJ process:value=1.37:type=mult requisite:max_count=2
REACTION REM1 math_2AC process:value=0.615:type=pow requisite:max_count=3
REACTION ABS2 math_1AJ process:value=0.83:type=mult
REACTION SUM2 math_2AN process:value=0.25:type=add
REACTION REM2 math_2AC process:value=1.19:type=mult
REACTION ABS3 math_1AJ process:value=0.3:type=pow
REACTION REM3 math_2AC process:value=0.77:type=add
REACTION ABS4 math_1AJ process:value=-0.45:type=pow
REACTION ABS5 math_1AJ process:value=0.33:type=add
REACTION ABS6 math_1AJ process:value=1.7:type=add
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(every=1):
    return [f"u 0:{every}:end Print{d.capitalize()}Data" for d in DATS]


_EVOLVED = {}


def _evolved(sysm):
    """An 8x8 population run EVOLVE updates from a mixed seeding on the
    port's kernel route with systematics on (the plain version): organisms
    mid-gestation, dividing and performing tasks.  Without systematics,
    the same state with the empty newborn ring of TPU_SYSTEMATICS=0."""
    if not _EVOLVED:
        vals = dict(VALS, TPU_SYSTEMATICS=1, TPU_USE_PALLAS=1)
        w = World(cfg=convert.config_from_dict(vals), data_dir=None,
                  device="cpu")
        w.events = []
        w.add_event("u begin InjectAll")
        w.process_events()
        _reseed_port(w)
        w.run(max_updates=EVOLVE)
        _EVOLVED[1] = convert.state_to_arrays(w.state)
        empty = convert.state_to_arrays(tstate.zeros_population(
            w.params.num_cells, w.params.max_memory, w.params.num_reactions))
        _EVOLVED[0] = dict(_EVOLVED[1], **{
            k: empty[k] for k in ("nb_genome", "nb_len", "nb_cell",
                                  "nb_parent", "nb_update", "nb_count")})
    return _EVOLVED[sysm]


def _start_pair(tmp_path, vals, arrays, update):
    cfg = rconfig.AvidaConfig()
    for k, v in vals.items():
        cfg.set(k, v)
    ref = RefWorld(cfg=cfg, data_dir=str(tmp_path / "ref"))
    port = World(cfg=convert.config_from_dict(vals),
                 data_dir=str(tmp_path / "port"), device="cpu")
    ref.events = [parse_event_line(e) for e in _events()]
    port.events = []
    for e in _events():
        port.add_event(e)
    ref.state = rstate.PopulationState(**{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    port.state = convert.state_from_arrays(arrays)
    ref.update = port.update = update
    return ref, port


@pytest.mark.parametrize("sysm", [0, 1])
def test_xla_engine_world_equals_reference(tmp_path, sysm):
    """TPU_USE_PALLAS=2: four updates of the evolved 8x8 world, state equal
    after each, .dat files equal (dominant.dat with systematics)."""
    vals = dict(VALS, TPU_SYSTEMATICS=sysm, TPU_USE_PALLAS=2)
    ref, port = _start_pair(tmp_path, vals, _evolved(sysm), EVOLVE)
    rep = port.engine_report()
    assert rep["engine"] == "per-update" and "kernel off" in \
        rep["fallback_reason"]
    tpc.reset_launches()
    for u in range(EVOLVE + 1, EVOLVE + 5):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_same_state(ref, port, u)
    assert int(port._total_births) == int(ref._total_births) > 0
    _assert_same_dats(tmp_path)
    assert tpc.LAUNCHES == 0


def _math_pair(tmp_path, use_pallas):
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "environment.cfg").write_text(MATH_ENV)
    (cdir / "avida.cfg").write_text("")
    vals = dict(VALS, RANDOM_SEED=5, TPU_SYSTEMATICS=0,
                TPU_USE_PALLAS=use_pallas)
    ov = list(vals.items())
    ref = RefWorld(config_dir=str(cdir), overrides=ov,
                   data_dir=str(tmp_path / "ref"))
    port = World(config_dir=str(cdir), overrides=ov,
                 data_dir=str(tmp_path / "port"), device="cpu")
    ref.events = [parse_event_line(e) for e in
                  ["u begin InjectAll"] + _events()]
    port.events = []
    for e in ["u begin InjectAll"] + _events():
        port.add_event(e)
    return ref, port


def test_math_environment_equals_reference(tmp_path):
    """Math-family reactions with fractional values under the default
    TPU_USE_PALLAS=0: both packages take their micro-step engine, and the
    rewards (exp2 of fractional values, products and sums of several per
    cycle) agree bit for bit over four updates."""
    ref, port = _math_pair(tmp_path, 0)
    assert port.params.num_reactions == 19
    assert port.engine_report()["engine"] == "per-update"
    _reseed_mixed(ref, port)
    tpc.reset_launches()
    for u in range(1, 5):
        assert ref.run(max_updates=u) == port.run(max_updates=u)
        _assert_same_state(ref, port, u)
    _assert_same_dats(tmp_path)
    assert tpc.LAUNCHES == 0
    total = port.state.task_exe_total.sum(dim=0).numpy()
    assert (total[9:] > 0).sum() >= 8           # the math reactions fire
    bonus = port.state.cur_bonus.numpy()
    assert (bonus != np.round(bonus)).any()     # fractional bonuses


def test_math_environment_refuses_forced_kernel(tmp_path):
    """TPU_USE_PALLAS=1 on a configuration the kernel gate refuses raises
    the reference's ValueError, in both packages, with the same text."""
    cdir = tmp_path / "cfg"
    cdir.mkdir()
    (cdir / "environment.cfg").write_text(MATH_ENV)
    (cdir / "avida.cfg").write_text("")
    ov = list(dict(VALS, TPU_SYSTEMATICS=0, TPU_USE_PALLAS=1).items())
    msgs = []
    for cls in (RefWorld, World):
        kw = {"device": "cpu"} if cls is World else {}
        with pytest.raises(ValueError, match="TPU_USE_PALLAS=1 but") as e:
            w = cls(config_dir=str(cdir), overrides=ov,
                    data_dir=str(tmp_path / cls.__module__), **kw)
            w.events = [parse_event_line("u begin InjectAll")]
            w.run(max_updates=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _cross_world(use_pallas):
    vals = dict(WORLD_X=8, WORLD_Y=8, TPU_MAX_MEMORY=200, RANDOM_SEED=11,
                COPY_MUT_PROB=0.0, DIVIDE_INS_PROB=0.0, DIVIDE_DEL_PROB=0.0,
                SLICING_METHOD=0, AVE_TIME_SLICE=100,
                TPU_MAX_STEPS_PER_UPDATE=100, TPU_SYSTEMATICS=0,
                TPU_USE_PALLAS=use_pallas)
    w = World(cfg=convert.config_from_dict(vals), data_dir=None,
              device="cpu")
    w.events = []
    w.inject()
    return w


def test_port_engines_agree():
    """The reference's cross-engine pattern on the port's two engines: the
    kernel (packed engine, plain version) and the micro-step engine from
    one seed, eight updates, every field equal after each but the lane
    permutation; the first divides land in the window."""
    wk, wx = _cross_world(1), _cross_world(2)
    assert wk.engine_report()["engine"] == "packed"
    assert wx.engine_report()["engine"] == "per-update"
    divided = False
    for u in range(1, 9):
        wk.run(max_updates=u)
        wx.run(max_updates=u)
        a = convert.state_to_arrays(wk.state)
        b = convert.state_to_arrays(wx.state)
        for k in a:
            if k in ("lane_perm", "lane_inv") or a[k] is None:
                continue
            assert a[k].tobytes() == b[k].tobytes(), (u, k)
        divided = divided or int(wx.state.num_divides.sum()) > 0
    assert divided and wx.num_organisms > 1
