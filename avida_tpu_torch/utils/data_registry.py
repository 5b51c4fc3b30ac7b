"""Data provider/recorder registry (the counterpart of
avida_tpu/utils/data_registry.py, itself the equivalent of the
reference's Avida::Data layer).

The reference decouples stat production from consumption: providers
announce typed values under dotted IDs, a Manager resolves IDs on demand,
and recorders (file writers, viewers) subscribe to ID sets
(include/public/avida/data/Manager.h:40-85, Provider.h:39-48,
Recorder.h:39-46).  Here the same protocol sits over the device-side
`summarize()` reductions: a provider is a host callable pulling from the
cached per-update summary (one device round-trip per update, shared by
every consumer), and a recorder is fed resolved rows at its print
cadence.  New .dat writers register providers/recorders instead of
editing World (the round-4 review's directive #9).

The generic `PrintData <file> <id,id,...>` action (cActionPrintData,
actions/PrintActions.cc:389-408) is the proof: any registered set of IDs
becomes a .dat file with no new World code.
"""

from __future__ import annotations

import numpy as np

from avida_tpu_torch.utils import output as output_mod


class DataManager:
    """ID -> provider registry + recorder attachment (Data::Manager)."""

    def __init__(self, world):
        self.world = world
        self._providers = {}        # id -> (description, fn(world) -> value)
        self._recorders = []

    # -- provider side (Data::Provider / ArgumentedProvider) --
    def register(self, data_id: str, description: str, fn):
        self._providers[data_id] = (description, fn)

    def available(self):
        return sorted(self._providers)

    def describe(self, data_id: str) -> str:
        return self._providers[data_id][0]

    def resolve(self, data_id: str):
        if data_id not in self._providers:
            raise KeyError(
                f"no data provider registered for {data_id!r} "
                f"(available: {', '.join(self.available())})")
        return self._providers[data_id][1](self.world)

    # -- recorder side (Data::Recorder) --
    def attach(self, recorder):
        self._recorders.append(recorder)

    def process(self, update: int):
        """Feed every attached recorder (called at its own cadence by the
        event loop; the reference calls recorders once per update)."""
        for r in self._recorders:
            r.record(update, self)


class DatRecorder:
    """A .dat-file recorder over a list of (data_id, column description).

    Golden-format output via utils.output.DatFile; one row per record()
    call (the caller controls cadence through the event system)."""

    def __init__(self, data_dir: str, filename: str, title: str, specs,
                 preamble=None, append: bool = False):
        self.specs = list(specs)
        self._file = output_mod.DatFile(
            f"{data_dir}/{filename}", title,
            [d for _, d in self.specs], preamble=preamble, append=append)

    def record(self, update: int, manager: DataManager):
        self._file.write_row(
            [manager.resolve(i) if i != "core.update" else update
             for i, _ in self.specs])

    def close(self):
        self._file.close()


def register_standard_providers(mgr: DataManager):
    """The core provider set, sourced from World._summary() (device
    reductions), the systematics manager, and host accumulators.  IDs
    follow the reference's dotted style (data/Manager.cc core.* space)."""
    S = lambda key: (lambda w: float(w._summary()[key]))          # noqa: E731
    Si = lambda key: (lambda w: int(w._summary()[key]))           # noqa: E731

    mgr.register("core.update", "Update", lambda w: w.update)
    mgr.register("core.world.organisms", "Count of organisms in the world",
                 Si("num_organisms"))
    mgr.register("core.world.ave_fitness", "Average Fitness",
                 S("ave_fitness"))
    mgr.register("core.world.ave_merit", "Average Merit", S("ave_merit"))
    mgr.register("core.world.ave_gestation_time", "Average Gestation Time",
                 S("ave_gestation"))
    mgr.register("core.world.ave_generation", "Average Generation",
                 S("ave_generation"))
    mgr.register("core.world.ave_age", "Average Organism Age", S("ave_age"))
    mgr.register("core.world.max_fitness", "Maximum Fitness",
                 S("max_fitness"))
    mgr.register("core.world.births", "Births this update",
                 Si("births_this_update"))
    mgr.register("core.world.genotypes",
                 "Count of genotypes in the world",
                 lambda w: w.systematics.num_genotypes if w.systematics
                 else 0)


def instruction_abundance(world):
    """Per-opcode instruction counts across all live genomes
    (cActionPrintInstructionAbundanceHistogram,
    actions/PrintActions.cc: sums cStats inst counts): one masked
    bincount over the opcode plane."""
    st = world.state
    genome = st.genome.cpu().numpy() & 63
    glen = st.genome_len.cpu().numpy()
    alive = st.alive.cpu().numpy()
    in_genome = (np.arange(genome.shape[1])[None, :] < glen[:, None]) \
        & alive[:, None]
    return np.bincount(genome[in_genome].ravel(),
                       minlength=world.params.num_insts)


def depth_histogram(world):
    """genotype depth -> count of genotypes (cActionPrintDepthHistogram)."""
    out = {}
    if world.systematics:
        for g in world.systematics.live_genotypes():
            out[g.depth] = out.get(g.depth, 0) + 1
    return dict(sorted(out.items()))


def abundance_histogram(world):
    """genotype abundance -> count of genotypes with that abundance
    (cActionPrintGenotypeAbundanceHistogram)."""
    out = {}
    if world.systematics:
        for g in world.systematics.live_genotypes():
            out[g.num_units] = out.get(g.num_units, 0) + 1
    return dict(sorted(out.items()))
