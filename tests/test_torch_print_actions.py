"""The print actions ported in slice 11 (PrintFitnessData,
PrintStatsData, PrintData through utils/data_registry.py,
PrintInstructionAbundanceHistogram, PrintDepthHistogram,
PrintGenotypeAbundanceHistogram, PrintTasksExeData, PrintTasksQualData)
against avida_tpu.

A 10x10 world with systematics on fires every action every update,
alongside the reference to update 3 and resumed from the reference's
generation there to update 5 (tasks_exe.dat's diff restarts from the
restored totals); tests/test_data_registry.py's golden window for
tasks_exe.dat / tasks_quality.dat; the registry's providers and a
recorder attached from outside World.

Tolerance: exact -- every .dat file byte for byte apart from the
header's date line, every state field after every update.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.config import default_instset  # noqa: E402
from avida_tpu_torch.utils.data_registry import DatRecorder  # noqa: E402

from test_torch_mating import feature_world, reseed  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread: the small worlds' many tiny
    operations run faster so, and beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PRINTS = ("PrintFitnessData", "PrintStatsData",
          "PrintInstructionAbundanceHistogram", "PrintDepthHistogram",
          "PrintGenotypeAbundanceHistogram", "PrintTasksExeData",
          "PrintTasksQualData")
DATA_IDS = ("core.update,core.world.organisms,core.world.ave_fitness,"
            "core.world.ave_merit,core.world.ave_gestation_time,"
            "core.world.ave_generation,core.world.ave_age,"
            "core.world.max_fitness,core.world.births,core.world.genotypes")
FILES = ("fitness", "stats", "instruction_histogram", "depth_histogram",
         "genotype_abundance_histogram", "tasks_exe", "tasks_quality",
         "mydata")


def task_ancestor(names, skip):
    """The default ancestor doing NAND before it copies itself: two
    inputs, their nand, the output, placed after h-alloc (seven body
    nops dropped; the body never runs), with the first `skip` of the
    seven left out, so the genotypes differ."""
    from avida_tpu_torch.world import default_ancestor
    anc = list(default_ancestor(default_instset()))
    io = ["IO", "nop-B", "IO", "nop-C", "nand", "IO", "nop-B"][skip:]
    anc[1:1] = [names.index(x) for x in io]
    del anc[12:12 + len(io)]
    return np.asarray(anc, np.int8)


def test_print_actions_equal_reference(tmp_path):
    """Every new print action each update on a 10x10 world of three
    genotypes doing NAND: the .dat files equal the reference's byte for
    byte, in the world run alongside it and in the one resumed from its
    generation."""
    names = list(default_instset().inst_names)
    genomes = [task_ancestor(names, k) for k in (0, 2, 4)]
    events = [f"u 0:1:end {a}" for a in PRINTS] + [
        f"u 0:1:end PrintData mydata.dat {DATA_IDS}"]
    ref, port, res = feature_world(
        tmp_path, names,
        dict(RANDOM_SEED=8, TPU_SYSTEMATICS=1),
        lambda w: reseed(w, genomes), stop=5, resume_at=3,
        events=events, dats=FILES)
    assert port.systematics is not None and port.systematics.num_genotypes
    rows = [ln.split() for ln in open(tmp_path / "res" / "tasks_exe.dat")
            if ln.strip() and not ln.startswith("#")]
    assert [r[0] for r in rows] == [str(u) for u in range(5)]
    assert any(int(v) for r in rows for v in r[1:])
    hist = [ln.split() for ln in open(
        tmp_path / "res" / "genotype_abundance_histogram.dat")
        if ln.strip() and not ln.startswith("#")]
    assert len(hist) > 5                # several abundances an update


def test_tasks_exe_and_quality_match_golden_window(tmp_path):
    """tests/test_data_registry.py's golden window in the port: the
    default 10x10 world from one ancestor, rows every 10 updates, every
    task column 0 before update 40, the instruction histogram summing to
    the live genome length."""
    from avida_tpu_torch.world import World
    w = World(cfg=convert.config_from_dict(dict(
        WORLD_X=10, WORLD_Y=10, RANDOM_SEED=7)), data_dir=str(tmp_path),
        device="cpu")
    for line in ("u 0:10:end PrintTasksExeData",
                 "u 0:10:end PrintTasksQualData",
                 "u 0:10:end PrintInstructionAbundanceHistogram"):
        w.add_event(line)
    w.run(max_updates=41)
    for fname, ncols in (("tasks_exe.dat", 10), ("tasks_quality.dat", 19)):
        got = [ln.split() for ln in open(tmp_path / fname)
               if ln.strip() and not ln.startswith("#")]
        assert len(got) >= 4, fname
        for i, row in enumerate(got[:4]):
            assert len(row) == ncols and row[0] == str(i * 10), (fname, row)
            assert all(v == "0" for v in row[1:]), (fname, row)
    hist = [ln.split() for ln in open(tmp_path / "instruction_histogram.dat")
            if ln.strip() and not ln.startswith("#")]
    alive = w.state.alive.numpy()
    assert sum(int(x) for x in hist[-1][1:]) == int(
        w.state.genome_len.numpy()[alive].sum())


def test_registry_providers_and_outside_recorder(tmp_path):
    """The providers resolve by ID (an unknown one raises), and a stat
    and recorder registered from outside World write a .dat file."""
    from avida_tpu_torch.world import World
    w = World(cfg=convert.config_from_dict(dict(WORLD_X=5, WORLD_Y=5)),
              data_dir=str(tmp_path), device="cpu")
    w.inject()
    assert "core.world.ave_fitness" in w.data.available()
    assert w.data.resolve("core.world.organisms") == 1
    with pytest.raises(KeyError):
        w.data.resolve("no.such.id")
    w.data.register("user.longest_genome", "Longest live genome",
                    lambda world: int(world.state.genome_len[
                        world.state.alive].max()))
    rec = DatRecorder(str(tmp_path), "custom.dat", "Custom data",
                      [("core.update", "Update"),
                       ("user.longest_genome", "Longest live genome")])
    w.data.attach(rec)
    w.data.process(w.update)
    body = [ln for ln in open(tmp_path / "custom.dat").read().splitlines()
            if ln and not ln.startswith("#")]
    assert body[0].split() == ["0", "100"]
    assert np.array_equal(
        np.asarray(w.data.resolve("core.world.genotypes")), 1)


def test_actions_cover_the_reference():
    """Every event action the reference's World handles is ported."""
    from avida_tpu.world import World as RefWorld
    from avida_tpu_torch.world import World
    want = {m[len("_action_"):] for m in dir(RefWorld)
            if m.startswith("_action_")}
    assert len(want) == 26
    assert want == set(World._ACTIONS)
    assert all(hasattr(World, f"_action_{a}") for a in World._ACTIONS)
