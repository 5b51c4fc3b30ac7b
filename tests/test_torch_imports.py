"""avida_tpu_torch stands alone: no JAX, nothing of avida_tpu, no silent
CPU fallback, and configurations outside the port fail loudly."""

import json
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
assert len(names) >= 25, names
assert {"avida_tpu_torch.systematics",
        "avida_tpu_torch.systematics.genotypes",
        "avida_tpu_torch.parallel",
        "avida_tpu_torch.parallel.multiworld",
        "avida_tpu_torch.ops.interpreter",
        "avida_tpu_torch.ops.tasks",
        "avida_tpu_torch.ops.digest",
        "avida_tpu_torch.ops.resources",
        "avida_tpu_torch.ops.demes",
        "avida_tpu_torch.ops.interpreter_smt",
        "avida_tpu_torch.models.transsmt",
        "avida_tpu_torch.models.experimental",
        "avida_tpu_torch.models.registry",
        "avida_tpu_torch.utils.data_registry",
        "avida_tpu_torch.utils.checkpoint",
        "avida_tpu_torch.utils.integrity",
        "avida_tpu_torch.utils.audit",
        "avida_tpu_torch.utils.spop",
        "avida_tpu_torch.observability",
        "avida_tpu_torch.observability.runlog",
        "avida_tpu_torch.observability.exporter",
        "avida_tpu_torch.observability.tracer",
        "avida_tpu_torch.observability.counters",
        "avida_tpu_torch.observability.timeline",
        "avida_tpu_torch.observability.staged",
        "avida_tpu_torch.observability.history",
        "avida_tpu_torch.observability.alerts",
        "avida_tpu_torch.observability.profiler",
        "avida_tpu_torch.observability.harness",
        "avida_tpu_torch.utils.faultinject",
        "avida_tpu_torch.systematics.test_metrics",
        "avida_tpu_torch.analyze",
        "avida_tpu_torch.analyze.testcpu",
        "avida_tpu_torch.analyze.trace",
        "avida_tpu_torch.analyze.analyzer",
        "avida_tpu_torch.analyze.pipeline",
        "avida_tpu_torch.observability.records",
        "avida_tpu_torch.service",
        "avida_tpu_torch.service.backoff",
        "avida_tpu_torch.service.supervisor",
        "avida_tpu_torch.tools",
        "avida_tpu_torch.tools.ckpt_tool",
        "avida_tpu_torch.tools.metrics_tool",
        "avida_tpu_torch.service.fleet",
        "avida_tpu_torch.service.serve",
        "avida_tpu_torch.tools.fleet_tool",
        "avida_tpu_torch.utils.churntrace",
        "avida_tpu_torch.utils.compilecache",
        "avida_tpu_torch.observability.events",
        "avida_tpu_torch.observability.perfread",
        "avida_tpu_torch.tools.cache_tool",
        "avida_tpu_torch.tools.trace_tool",
        "avida_tpu_torch.tools.perf_tool",
        "avida_tpu_torch.tools.analyze_tool"} <= set(names), names
"""

# a checkpointed run and its resume end to end (a 4x4 world, 2 + 2
# updates): the persistence modules load without jax or avida_tpu
_RESUME_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
common = ["-set", "WORLD_X", "4", "-set", "WORLD_Y", "4", "--device", "cpu",
          "-d", sys.argv[1], "-set", "TPU_CKPT_DIR", sys.argv[2],
          "-set", "TPU_CKPT_FINAL", "1", "-set", "TPU_STATE_DIGEST", "1",
          "-set", "TPU_SCRUB_EVERY", "1", "-set", "TPU_AUDIT_EVERY", "1"]
assert main(["-u", "2"] + common) == 0
assert main(["-u", "4", "--resume"] + common) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
for m in ("avida_tpu_torch.utils.checkpoint", "avida_tpu_torch.ops.digest",
          "avida_tpu_torch.utils.audit"):
    assert m in sys.modules, m
assert not bad, bad
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


# the serving layer: its three classes import without jax or avida_tpu,
# and a --serve-worlds child serves one 4x4 tenant two updates (W = 2,
# the control asking for shutdown once it is done)
_SERVE_CLI = r"""
import json, sys
from avida_tpu_torch.observability.exporter import ServeExporter
from avida_tpu_torch.parallel.multiworld import ServeBatch
from avida_tpu_torch.service.serve import ServePool
from avida_tpu_torch.__main__ import main
d = sys.argv[1]
with open(d + "/ctl.json", "w") as f:
    json.dump({"width": 2, "shutdown": True, "members": [
        {"name": "t", "seed": 3, "data_dir": d + "/t", "ckpt_dir": d + "/ck",
         "max_updates": 2}]}, f)
rc = main(["--serve-worlds", d + "/ctl.json", "-set", "WORLD_X", "4",
           "-set", "WORLD_Y", "4", "-set", "TPU_CKPT_EVERY", "2",
           "-set", "TPU_METRICS", "1", "--device", "cpu", "-d", d + "/batch"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
assert rc == 0, rc
assert not bad, bad
"""


def test_serve_cli_imports_no_jax_and_no_reference(tmp_path):
    """ServePool, ServeBatch and ServeExporter import, and a serve child
    runs, with no jax and nothing of avida_tpu in sys.modules."""
    res = subprocess.run([sys.executable, "-c", _SERVE_CLI, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(tmp_path / "batch" / "serve.json") as f:
        st = json.load(f)
    assert st["finished"]["t"]["state"] == "done" and st["ghosts"] == 2
    assert (tmp_path / "batch" / "multiworld.prom").exists()


def test_xla_engine_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _XLA_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# slice 10 end to end: a 4x4 kernel-route world with dispersal at a rate
# of 12 (the rejection sampler), a cap and the hex table, and a
# micro-step world with energy and two threads, one update each
_SLICE10_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
base = ["-u", "1", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
        "--device", "cpu"]
assert main(base + ["-set", "BIRTH_METHOD", "11", "-set", "DISPERSAL_RATE",
                    "12", "-set", "POPULATION_CAP", "10", "-set",
                    "WORLD_GEOMETRY", "4", "-d", sys.argv[1] + "/a"]) == 0
assert main(base + ["-set", "ENERGY_ENABLED", "1", "-set",
                    "MAX_CPU_THREADS", "2", "-d", sys.argv[1] + "/b"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
assert not bad, bad
"""


def test_slice10_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _SLICE10_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# slice 11 end to end: a 4x4 predator-prey world on experimental
# hardware and a packed world on the 5-bit genome plane, two updates each
_SLICE11_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
base = ["-u", "2", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
        "--device", "cpu"]
assert main(base + ["-set", "INST_SET", "experimental",
                    "-set", "PRED_PREY_SWITCH", "0",
                    "-d", sys.argv[1] + "/exp"]) == 0
assert main(base + ["-set", "TPU_SYSTEMATICS", "0",
                    "-set", "TPU_PACKED_BITS", "1",
                    "-d", sys.argv[1] + "/bits"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
for m in ("avida_tpu_torch.models.experimental",
          "avida_tpu_torch.utils.data_registry"):
    assert m in sys.modules, m
assert not bad, bad
"""


def test_slice11_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _SLICE11_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert os.path.exists(tmp_path / "data" / "exp" / "average.dat")


# slice 12 end to end: a checkpointed 4x4 run with the reversion test and
# live analytics (its exit census runs the Test CPU), then bare -a over an
# analyze.cfg that recalculates the ancestor
_SLICE12_CLI = r"""
import os, sys
from avida_tpu_torch.__main__ import main
from avida_tpu_torch.config import default_instset
from avida_tpu_torch.utils.spop import _seq_to_string
from avida_tpu_torch.world import default_ancestor
d, cdir = sys.argv[1], sys.argv[2]
assert main(["-u", "2", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
             "-set", "REVERT_FATAL", "1", "-set", "STERILIZE_NEUTRAL", "0.5",
             "-set", "TPU_ANALYTICS", "1", "-set", "TPU_CKPT_DIR", d + "/ck",
             "--device", "cpu", "-d", d + "/run"]) == 0
os.makedirs(cdir)
open(cdir + "/avida.cfg", "w").write("WORLD_X 4\nWORLD_Y 4\n")
seq = _seq_to_string(default_ancestor(default_instset()))
open(cdir + "/analyze.cfg", "w").write(
    f"LOAD_SEQUENCE {seq}\nRECALCULATE\nDETAIL d.dat id fitness\n")
assert main(["-c", cdir, "-a", "-d", d + "/az", "--device", "cpu"]) == 0
assert main(["-a", cdir + "/analyze.cfg", "--device", "cpu"]) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
for m in ("avida_tpu_torch.analyze.testcpu",
          "avida_tpu_torch.analyze.analyzer",
          "avida_tpu_torch.analyze.pipeline",
          "avida_tpu_torch.systematics.test_metrics",
          "avida_tpu_torch.observability.exporter"):
    assert m in sys.modules, m
assert not bad, bad
"""


def test_slice12_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _SLICE12_CLI,
                          str(tmp_path / "data"), str(tmp_path / "cfg")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    d = tmp_path / "data"
    assert (d / "run" / "analytics.prom").exists()
    assert "0.249357" in (d / "az" / "d.dat").read_text()


def test_multiworld_refuses_reversion_and_live_analytics():
    """A batch member with the reversion test or live analytics is
    refused with the reference's reasons."""
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    for name, needle in (("REVERT_FATAL", "chunkable"),
                         ("TPU_ANALYTICS", "live analytics")):
        with pytest.raises(ValueError, match=needle):
            MultiWorld.from_seeds([1, 2], overrides=[(name, 1)],
                                  data_dir="/nonexistent", device="cpu")


def test_resume_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _RESUME_CLI,
                          str(tmp_path / "data"), str(tmp_path / "ck")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ckpt-000000000002", "ckpt-000000000004"]


@pytest.mark.parametrize("name,value", [
    ("TPU_CKPT_EVERY", 5), ("TPU_CKPT_FINAL", 1), ("TPU_STATE_DIGEST", 1),
    ("TPU_SCRUB_EVERY", 2), ("TPU_AUDIT_EVERY", 3)])
def test_persistence_switches_accepted(name, value):
    """The five persistence switches the port refused before it ran them
    are accepted and reach the World's run loop."""
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(**{name: value}), device="cpu")
    assert w.cfg.get(name) == value
    if name == "TPU_STATE_DIGEST":
        assert w._digest_on
    if name == "TPU_SCRUB_EVERY":
        assert w._scrub_every == value


@pytest.mark.parametrize("name,value", [
    ("TPU_KERNEL_SHARDS", 2), ("TPU_KERNEL_SHARDS", 8),
    ("TPU_USE_PALLAS", 3)])
def test_observability_switches_still_refused(name, value):
    """The observability plane retired five of the switches World
    refused (TPU_TELEMETRY, TPU_TRACE, TPU_METRICS, TPU_PROFILE,
    TPU_FAULT); the two left still raise by name."""
    from avida_tpu_torch.world import _OFF_SWITCHES, World
    assert [n for n, _, _ in _OFF_SWITCHES] == ["TPU_USE_PALLAS",
                                                "TPU_KERNEL_SHARDS"]
    with pytest.raises(NotImplementedError, match=name):
        World(cfg=_cfg(**{name: value}), device="cpu")


def test_ckpt_dir_alone_arms_preemption(tmp_path):
    """TPU_CKPT_DIR alone installs the SIGTERM/SIGINT handlers for the
    run: a SIGTERM mid-run stops it at the next chunk boundary with a
    final generation (preempted), the handlers are restored after, and
    without TPU_CKPT_DIR the run installs nothing."""
    import signal
    from avida_tpu_torch.utils import checkpoint as ckpt_mod
    from avida_tpu_torch.world import World
    before = signal.getsignal(signal.SIGTERM)
    w = World(cfg=_cfg(TPU_CKPT_DIR=str(tmp_path / "ck"),
                       TPU_MAX_STRETCH=2), data_dir=str(tmp_path / "d"),
              device="cpu")
    seen = []
    real = w._scan_updates

    def scan(k):
        seen.append(signal.getsignal(signal.SIGTERM))
        if len(seen) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(k)

    w._scan_updates = scan
    w.run(max_updates=20)
    assert w.preempted and w.update == 4
    assert seen[0] is not before
    assert signal.getsignal(signal.SIGTERM) is before
    gens = ckpt_mod.list_generations(str(tmp_path / "ck"))
    assert [ckpt_mod.generation_update(g) for g in gens] == [4]
    v = World(cfg=_cfg(), data_dir=str(tmp_path / "e"), device="cpu")
    v._scan_updates = lambda k, real=v._scan_updates: (
        seen.append(signal.getsignal(signal.SIGTERM)), real(k))[1]
    v.run(max_updates=2)
    assert seen[-1] is before


def test_second_sigint_escalates(tmp_path):
    """A first SIGINT requests the boundary stop; a second one raises
    KeyboardInterrupt at once (the reference's escalation)."""
    import signal
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_CKPT_DIR=str(tmp_path / "ck")),
              data_dir=str(tmp_path / "d"), device="cpu")
    handlers = w._install_preempt_handlers()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert w._preempt
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)


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
    ({"TPU_SYSTEMATICS": 1, "BIRTH_METHOD": 12}, "per-update engine"),
    ({"WORLD_GEOMETRY": 0}, "WORLD_GEOMETRY 0"),
    ({"WORLD_GEOMETRY": 5}, "WORLD_GEOMETRY 5"),
    ({"TPU_USE_PALLAS": 3}, "TPU_USE_PALLAS"),
    ({"POINT_MUT_PROB": 0.01, "BIRTH_METHOD": 13}, "per-update engine"),
    ({"TPU_KERNEL_SHARDS": 2}, "TPU_KERNEL_SHARDS"),
    ({"TPU_KERNEL_SHARDS": 2, "TPU_SYSTEMATICS": 0}, "TPU_KERNEL_SHARDS"),
    ({"TPU_KERNEL_SHARDS": 2, "TPU_TRACE": 1}, "TPU_KERNEL_SHARDS"),
    ({"TPU_USE_PALLAS": 4, "TPU_TELEMETRY": 1}, "TPU_USE_PALLAS"),
    ({"INST_SET": "heads_sex", "BIRTH_METHOD": -1}, "BIRTH_METHOD -1"),
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
    ({"BIRTH_METHOD": 11}, "off the torus fast path"),
    ({"POPULATION_CAP": 10}, "off the torus fast path"),
    ({"POP_CAP_ELDEST": 10}, "off the torus fast path"),
    ({"WORLD_GEOMETRY": 4}, "off the torus fast path"),
    ({"WORLD_GEOMETRY": 3}, "off the torus fast path"),
    ({"WORLD_GEOMETRY": 8}, "off the torus fast path"),
    ({"INST_SET": "heads_sex", "MATING_TYPES": 1},
     "divide-sex instruction set"),
    ({"ENERGY_ENABLED": 1}, "Pallas cycle kernel off"),
    ({"MAX_CPU_THREADS": 2}, "non-heads hardware or multi-threaded"),
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
    ({"max_cpu_threads": 2}, None),
    ({"energy_enabled": True}, None),
    ({"sem": "fork"}, None),
    ({"sem": "mating"}, None),
    ({"hw_type": 3}, None),
])
def test_engine_refusals_name_their_item(replace, needle, use_pallas):
    """What neither cycle engine runs is refused at World construction by
    name, with the ROADMAP.md item that owns it, on either route; threads,
    their instructions, the mating-type instructions, the energy model
    (items 12e and 12f) and experimental hardware (item 12h) run on the
    micro-step engine and pass."""
    from avida_tpu_torch.models.heads import SEM_FORK_TH, SEM_SET_MATE_MALE
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_USE_PALLAS=use_pallas), device="cpu")
    if replace.get("sem") == "fork":
        replace = {"sem": w.params.sem[:-1] + (SEM_FORK_TH,)}
    elif replace.get("sem") == "mating":
        replace = {"sem": w.params.sem[:-1] + (SEM_SET_MATE_MALE,)}
    w.params = w.params.replace(**replace)
    if needle is None:
        from avida_tpu_torch.ops import cycles
        w._check_engine()
        assert not cycles.use_kernel(w.params)
        return
    with pytest.raises(NotImplementedError, match=needle):
        w._check_engine()


# the TransSMT world end to end (a 4x4 world, the parasite in cells
# 0-7, one update): the SMT modules load without jax or avida_tpu
_SMT_CLI = r"""
import sys
from avida_tpu_torch.__main__ import main
rc = main(["-u", "1", "-set", "WORLD_X", "4", "-set", "WORLD_Y", "4",
           "-set", "INST_SET", "transsmt", "--device", "cpu",
           "-d", sys.argv[1]])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "avida_tpu" or m.startswith("avida_tpu."))
assert rc == 0, rc
for m in ("avida_tpu_torch.ops.interpreter_smt",
          "avida_tpu_torch.models.transsmt"):
    assert m in sys.modules, m
assert not bad, bad
"""


def test_transsmt_cli_imports_no_jax_and_no_reference(tmp_path):
    res = subprocess.run([sys.executable, "-c", _SMT_CLI,
                          str(tmp_path / "data")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("inst_set", ["transsmt", "instset-smt.cfg"])
def test_transsmt_is_not_refused(inst_set):
    """TransSMT hardware (ROADMAP.md item 12c) is ported: both names of the
    instruction set select it, on the micro-step engine, and InjectParasite
    is an accepted action."""
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(INST_SET=inst_set), device="cpu")
    assert w.params.hw_type == 2
    w._check_engine()
    rep = w.engine_report()
    assert rep["engine"] == "per-update"
    assert "non-heads hardware" in rep["fallback_reason"]
    w.add_event("u 1 InjectParasite - - 0 4")


@pytest.mark.parametrize("column", ["cost", "ft_cost", "prob_fail",
                                    "addl_time_cost"])
def test_transsmt_cost_columns_refused_by_name(tmp_path, column):
    """The reference's own TransSMT limits stay: cost, ft_cost, prob_fail
    and addl_time_cost columns, and MAX_CPU_THREADS > 1."""
    from avida_tpu_torch.config import transsmt_instset
    from avida_tpu_torch.world import World
    names = transsmt_instset().inst_names
    vals = {"cost": 2, "ft_cost": 3, "prob_fail": 0.5, "addl_time_cost": 1}
    lines = ["INSTSET transsmt:hw_type=2"] + [
        f"INST {nm}" + (f":{column}={vals[column]}" if k == 5 else "")
        for k, nm in enumerate(names)]
    (tmp_path / "instset.cfg").write_text("\n".join(lines) + "\n")
    (tmp_path / "avida.cfg").write_text("INST_SET instset.cfg\n")
    with pytest.raises(NotImplementedError, match="TransSMT"):
        World(config_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="MAX_CPU_THREADS"):
        World(cfg=_cfg(INST_SET="transsmt", MAX_CPU_THREADS=2),
              device="cpu")


def test_experimental_hardware_refused_by_name(tmp_path):
    """HARDWARE_TYPE 3 (experimental spatial hardware, ROADMAP.md item
    12h) is no longer refused: its instruction-set names and a file's
    hw_type build an 8-register world on the micro-step engine."""
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.world import World
    for inst_set in ("experimental", "pred_look"):
        w = World(cfg=_cfg(INST_SET=inst_set), device="cpu")
        assert w.params.hw_type == 3 and w.params.num_registers == 8
        assert not cycles.use_kernel(w.params)
    (tmp_path / "instset.cfg").write_text(
        "INSTSET exp:hw_type=3\nINST nop-A\nINST nop-B\nINST h-divide\n")
    (tmp_path / "avida.cfg").write_text("INST_SET instset.cfg\n")
    assert World(config_dir=str(tmp_path), device="cpu").params.hw_type == 3


@pytest.mark.parametrize("use_pallas", [0, 2])
@pytest.mark.parametrize("replace", [
    {"proc_product_idx": (0,) + (-1,) * 8, "num_global_res": 1,
     "proc_conversion": (1.0,) * 9},
    {"proc_res_idx": (0,) + (-1,) * 8, "num_global_res": 1},
])
def test_pool_configs_take_the_micro_step_engine(replace, use_pallas):
    """By-products and resource-bound reactions (ROADMAP.md item 12a,
    ported) are accepted on either route and run the micro-step engine:
    the kernel gate refuses them, as the reference's does."""
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_USE_PALLAS=use_pallas), device="cpu")
    w.params = w.params.replace(**replace)
    w._check_engine()
    rep = w.engine_report()
    assert rep["engine"] == "per-update"
    assert "kernel off" in rep["fallback_reason"]


def test_multiworld_refuses_pools_and_demes_by_name():
    """Batches whose members hold demes or resource pools stay refused,
    naming ROADMAP.md item 14."""
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    from avida_tpu_torch.world import World
    with pytest.raises(NotImplementedError, match="item 14"):
        MultiWorld.from_seeds([1, 2], overrides=[("NUM_DEMES", 4)],
                              data_dir="/nonexistent", device="cpu")
    worlds = [World(cfg=_cfg(RANDOM_SEED=s), data_dir=f"/nonexistent/w{s}",
                    device="cpu") for s in (1, 2)]
    for w in worlds:
        w.params = w.params.replace(num_global_res=1, res_initial=(5.0,))
    with pytest.raises(NotImplementedError, match="item 14"):
        MultiWorld(worlds)


def test_kernel_limits_refused_by_name_on_cuda():
    """On a CUDA device the kernel route takes any tape height and any
    reaction count -- a CHUNK-padded tape of 1088 sites, 33 reactions --
    and refuses only more than 64 instructions, naming the reference
    kernel's own limit; the CPU's plain version and the micro-step engine
    refuse nothing here."""
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(TPU_MAX_MEMORY=1088), device="cpu")
    p = w.params
    assert cycles.dims(p, p.num_cells, p.max_memory)[2] == 1088
    assert cycles.kernel_limit_reason(p, "cuda") is None
    assert cycles.kernel_limit_reason(p, "cpu") is None
    assert cycles.kernel_limit_reason(p.replace(use_pallas=2), "cuda") is None
    w.device = torch.device("cuda")
    w._check_engine()
    q = World(cfg=_cfg(), device="cpu").params
    assert cycles.kernel_limit_reason(q, "cuda") is None
    r33 = q.replace(num_reactions=33)
    assert cycles.kernel_limit_reason(r33, "cuda") is None
    big = q.replace(num_insts=65)
    reason = cycles.kernel_limit_reason(big, "cuda")
    assert "at most 64 instructions" in reason and "pallas_cycles" in reason
    assert cycles.kernel_limit_reason(big, "cpu") is None


@pytest.mark.parametrize("overrides", [
    {"BIRTH_METHOD": 11, "DISPERSAL_RATE": 12.0}, {"POPULATION_CAP": 10},
    {"POP_CAP_ELDEST": 10}, {"WORLD_GEOMETRY": 3}, {"WORLD_GEOMETRY": 4},
    {"WORLD_GEOMETRY": 6}, {"WORLD_GEOMETRY": 7}, {"WORLD_GEOMETRY": 8},
    {"INST_SET": "heads_sex", "MATING_TYPES": 1},
    {"ENERGY_ENABLED": 1, "BIRTH_METHOD": 9},
    {"MAX_CPU_THREADS": 4, "THREAD_SLICING_METHOD": 1}])
def test_slice10_refusals_retired(overrides):
    """ROADMAP items 12d-12g run: dispersal, population caps, every
    geometry the reference builds, mating types, energy and threads
    construct a World with no refusal, and neither the flush's gate nor
    the engines' names them."""
    from avida_tpu_torch.ops import birth, update
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(**overrides), device="cpu")
    assert birth.canonical_unsupported_reason(w.params) is None
    assert update.per_update_unported_reason(w.params) is None


def test_unported_event_action_raises():
    from avida_tpu_torch.world import World
    w = World(cfg=_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="KillRectangle"):
        w.add_event("u 10 KillRectangle 0 0 2 2")
    for line in ("u 10 KillProb 0.5", "u 20 SerialTransfer 10"):
        w.add_event(line)


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
