"""avida_tpu_torch stands alone: no JAX, nothing of avida_tpu, no silent
CPU fallback, and configurations outside the port fail loudly."""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import avida_tpu_torch
names = [m.name for m in pkgutil.walk_packages(avida_tpu_torch.__path__,
                                               "avida_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 18, names
assert {"avida_tpu_torch.systematics",
        "avida_tpu_torch.systematics.genotypes",
        "avida_tpu_torch.parallel",
        "avida_tpu_torch.parallel.multiworld",
        "avida_tpu_torch.ops.interpreter",
        "avida_tpu_torch.ops.tasks"} <= set(names), names
"""

# the micro-step engine end to end (TPU_USE_PALLAS 2, a 4x4 world, one
# update)
_XLA_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
rc = main(["-u", "1", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
           "-set", "TPU_USE_PALLAS", "2", "--device", "cpu",
           "-d", sys.argv[1]])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
assert rc == 0, rc
assert "avida_tpu_torch.ops.tasks" in sys.modules
assert not bad, bad
"""

# the --worlds path end to end (a 4x4 batch of two worlds, one update)
_WORLDS_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
rc = main(["--worlds", "1,2", "-u", "1", "-set", "WORLD_X", "4",
           "-set", "WORLD_Y", "4", "--device", "cpu", "-d", sys.argv[1]])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
assert rc == 0, rc
assert "avida_tpu_torch.parallel.multiworld" in sys.modules
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_worlds_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _WORLDS_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '"worlds": 2' in res.stdout
    assert sorted(os.listdir(tmp_path / "data")) == ["w000", "w001"]


def test_xla_engine_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _XLA_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_world_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: World() runs on it")
    from avida_tpu_torch.world import World
    with pytest.raises(RuntimeError, match="CUDA"):
        World()


def _cfg(**kw):
    from avida_tpu_torch import convert
    vals = dict(WORLD_X=6, WORLD_Y=6, RANDOM_SEED=1, TPU_SYSTEMATICS=0)
    vals.update(kw)
    return convert.config_from_dict(vals)


@pytest.mark.parametrize("overrides,needle", [
    ({"TPU_SYSTEMATICS": 1, "POPULATION_CAP": 10}, "per-update engine"),
    ({"BIRTH_METHOD": 11}, "BIRTH_METHOD 11"),
    ({"WORLD_GEOMETRY": 3}, "WORLD_GEOMETRY 3"),
    ({"TPU_USE_PALLAS": 3}, "TPU_USE_PALLAS"),
    ({"POINT_MUT_PROB": 0.01, "WORLD_GEOMETRY": 4}, "per-update engine"),
    ({"TPU_PACKED_BITS": 1}, "TPU_PACKED_BITS"),
    ({"TPU_TRACE": 1}, "TPU_TRACE"),
    ({"REVERT_FATAL": 0.5}, "REVERT_FATAL"),
    ({"INST_SET": "instset-smt.cfg"}, "INST_SET"),
    ({"INST_SET": "heads_sex", "MATING_TYPES": 1}, "MATING_TYPES"),
    ({"TPU_KERNEL_SHARDS": 4}, "TPU_KERNEL_SHARDS"),
])
def test_out_of_slice_configs_raise(overrides, needle):
    from avida_tpu_torch.world import World
    with pytest.raises(NotImplementedError, match=needle):
        World(cfg=_cfg(**overrides), device="cpu")


@pytest.mark.parametrize("overrides,reason", [
    ({"TPU_SYSTEMATICS": 1}, "systematics newborn ring"),
    ({"POINT_MUT_PROB": 0.01}, "point or slip"),
    ({"INST_SET": "heads_sex"}, "divide-sex instruction set"),
    ({"BIRTH_METHOD": 4, "WORLD_GEOMETRY": 1}, "off the torus fast path"),
    ({"BIRTH_METHOD": 7}, "off the torus fast path"),
])
def test_per_update_configs_route_and_report(overrides, reason):
    """Systematics (the reference's default), point mutations, divide-sex
    and placement off the torus fast path run the per-update engine, and
    engine_report says so in the reference's words; with none of them,
    the packed engine."""
    from avida_tpu_torch.world import World
    rep = World(cfg=_cfg(**overrides), device="cpu").engine_report()
    assert rep["engine"] == "per-update"
    assert reason in rep["fallback_reason"]
    assert World(cfg=_cfg(), device="cpu").engine_report() == {
        "engine": "packed", "sub_path": "fused", "packed_bits": 0}


@pytest.mark.parametrize("use_pallas", [0, 2])
@pytest.mark.parametrize("replace,needle", [
    ({"max_cpu_threads": 2}, "item 12f"),
    ({"energy_enabled": True}, "item 12f"),
    ({"sem": "fork"}, "item 12f"),
    ({"sem": "mating"}, "item 12e"),
    ({"proc_product_idx": (0,) + (-1,) * 8}, "item 12a"),
    ({"proc_res_idx": (0,) + (-1,) * 8}, "item 12a"),
    ({"hw_type": 1}, "item 12c"),
])
def test_engine_refusals_name_their_item(replace, needle, use_pallas):
    """What neither cycle engine runs is refused at World construction by
    name, with the ROADMAP.md item that owns it, on either route."""
    from avida_tpu_torch.models.heads import SEM_FORK_TH, SEM_SET_MATE_MALE
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_USE_PALLAS=use_pallas), device="cpu")
    if replace.get("sem") == "fork":
        replace = {"sem": w.params.sem[:-1] + (SEM_FORK_TH,)}
    elif replace.get("sem") == "mating":
        replace = {"sem": w.params.sem[:-1] + (SEM_SET_MATE_MALE,)}
    w.params = w.params.replace(**replace)
    with pytest.raises(NotImplementedError, match=needle):
        w._check_engine()


def test_kernel_limits_refused_by_name_on_cuda():
    """On a CUDA device the kernel route refuses what csrc/cycles.cu cannot
    hold -- a CHUNK-padded tape over 1024 sites, more than 32 reactions,
    more than 64 instructions -- naming the limit and TPU_USE_PALLAS=2;
    the CPU's plain version and the micro-step engine take them."""
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_MAX_MEMORY=1088), device="cpu")
    p = w.params
    assert cycles.dims(p, p.num_cells, p.max_memory)[2] == 1088
    reason = cycles.kernel_limit_reason(p, "cuda")
    assert "1024 sites" in reason and "TPU_USE_PALLAS=2" in reason
    assert cycles.kernel_limit_reason(p, "cpu") is None
    assert cycles.kernel_limit_reason(p.replace(use_pallas=2), "cuda") is None
    w.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="1024 sites"):
        w._check_engine()
    q = World(cfg=_cfg(), device="cpu").params
    assert cycles.kernel_limit_reason(q, "cuda") is None
    r33 = q.replace(num_reactions=33)
    assert "at most 32 reactions" in cycles.kernel_limit_reason(r33, "cuda")
    big = q.replace(num_insts=65)
    assert "64 instructions" in cycles.kernel_limit_reason(big, "cuda")


def test_unported_event_action_raises():
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="SavePopulation"):
        w.add_event("u 10 SavePopulation")


def test_wrapper_refuses_other_devices():
    """The cycle wrapper takes the plain version only for CPU tensors; any
    other device launches the kernel or raises."""
    from avida_tpu_torch.core.state import WorldParams
    from avida_tpu_torch.config import default_instset
    from avida_tpu_torch.config.environment import default_logic9_environment
    from avida_tpu_torch.core.state import make_world_params
    from avida_tpu_torch.ops import cycles
    p = make_world_params(_cfg(), default_instset(),
                          default_logic9_environment())
    assert isinstance(p, WorldParams)
    NI = cycles.layout(p, 384)[0]
    meta = [torch.empty((96, 128), dtype=torch.int32, device="meta"),
            torch.empty((96, 128), dtype=torch.int32, device="meta"),
            torch.empty((NI, 128), dtype=torch.int32, device="meta"),
            torch.empty((8, 128), dtype=torch.float32, device="meta")]
    seeds = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no cycle kernel"):
        cycles.cycles(p, tuple(meta), seeds, 10, 128)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
