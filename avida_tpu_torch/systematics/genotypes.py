"""Live phylogeny: genotype dedup, parent links, depth, extinction.

Counterpart of avida_tpu/systematics/genotypes.py (numpy only, copied so
this package imports nothing of the reference).  Checkpoint snapshots
(`to_snapshot` / `from_snapshot`) are the reference's systematics.json,
written and read by utils/checkpoint.py.

Host-side re-expression of the reference's systematics layer
(Systematics::GenotypeArbiter, avida-core/source/systematics/
GenotypeArbiter.cc:79 ClassifyNewUnit; active-genotype hash :89-96;
threshold/coalescence bookkeeping; LegacySave :123).  The device never
blocks on this: each update the world hands over only the *newborn* rows
(a small gather keyed on birth_update == current update) and the host does
all bookkeeping -- the provenance layer rides the update stream instead of
sitting inside the hot loop.

Deviation from the reference (documented): classification happens at
update granularity, not at the instant of birth.  Within one lockstep
update every newborn sees its parent's genotype as of the update start,
which is exactly the information order the flush-births scatter defines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Genotype:
    """One distinct genome (ref Systematics::Genotype, systematics/Genotype.h)."""
    gid: int
    sequence: np.ndarray          # int8[len]
    parent_gid: int               # -1 for injected ancestors
    depth: int                    # phylogenetic depth (parent.depth + 1)
    update_born: int
    num_units: int = 0            # live organisms with this genome
    total_units: int = 0          # ever born
    last_birth_update: int = -1
    update_deactivated: int = -1  # update the last live unit died (-1 = active)
    threshold: bool = False       # passed abundance threshold (ref :183)
    merit_sum: float = 0.0        # running stats for dominant reporting
    fitness_sum: float = 0.0
    gestation_sum: float = 0.0
    stat_n: int = 0

    @property
    def length(self) -> int:
        return int(len(self.sequence))


class GenotypeArbiter:
    """Classify organisms into genotypes and maintain the live phylogeny.

    Usage: call `process(update, alive, newborn_cells, newborn_genomes,
    newborn_lens, parent_cells)` once per update; query `dominant()`,
    `num_genotypes`, `coalescent_depth()` for stats output.
    """

    def __init__(self, world_cells: int, threshold: int = 3):
        self.threshold = threshold
        self._by_seq: dict[bytes, Genotype] = {}
        self.genotypes: dict[int, Genotype] = {}
        self.cell_gid = np.full(world_cells, -1, np.int64)  # cell -> genotype id
        self._next_id = 1
        self.num_births_total = 0

    # -- classification ---------------------------------------------------

    def classify_seed(self, cell: int, genome: np.ndarray, update: int = -1):
        """Register an injected organism (ref InjectClone / ActivateOrganism)."""
        self._activate(cell, np.asarray(genome, np.int8), parent_gid=-1,
                       update=update)

    def classify_seed_all(self, genome: np.ndarray, update: int = -1):
        """Bulk InjectAll registration (cActionInjectAll): every cell
        becomes one unit of a single genotype in O(previously occupied)
        host work instead of num_cells _activate calls (round-4 review
        weak #7)."""
        seq = np.asarray(genome, np.int8)
        for cell in np.nonzero(self.cell_gid >= 0)[0]:
            self._remove_unit(int(self.cell_gid[cell]), update)
        key = seq.tobytes()
        g = self._by_seq.get(key)
        if g is None:
            g = Genotype(gid=self._next_id, sequence=seq.copy(),
                         parent_gid=-1, depth=0, update_born=update)
            self._next_id += 1
            self._by_seq[key] = g
            self.genotypes[g.gid] = g
        n = self.cell_gid.shape[0]
        # same per-unit bookkeeping as _activate, batched
        g.num_units += n
        g.total_units += n
        g.last_birth_update = update
        g.update_deactivated = -1
        if g.total_units >= self.threshold:
            g.threshold = True
        self.num_births_total += n
        self.cell_gid[:] = g.gid

    def _activate(self, cell: int, seq: np.ndarray, parent_gid: int, update: int):
        key = seq.tobytes()
        g = self._by_seq.get(key)
        if g is None:
            depth = 0
            if parent_gid >= 0 and parent_gid in self.genotypes:
                depth = self.genotypes[parent_gid].depth + 1
            g = Genotype(gid=self._next_id, sequence=seq.copy(),
                         parent_gid=parent_gid, depth=depth, update_born=update)
            self._next_id += 1
            self._by_seq[key] = g
            self.genotypes[g.gid] = g
        old = self.cell_gid[cell]
        if old >= 0:
            self._remove_unit(int(old), update)
        g.num_units += 1
        g.total_units += 1
        g.last_birth_update = update
        g.update_deactivated = -1
        if g.total_units >= self.threshold:
            g.threshold = True
        self.cell_gid[cell] = g.gid
        self.num_births_total += 1

    def _remove_unit(self, gid: int, update: int):
        g = self.genotypes.get(gid)
        if g is None:
            return
        g.num_units -= 1
        if g.num_units <= 0:
            g.num_units = 0
            g.update_deactivated = update

    # -- per-update ingestion ---------------------------------------------

    def process(self, update: int, alive: np.ndarray,
                newborn_cells: np.ndarray, newborn_genomes: np.ndarray,
                newborn_lens: np.ndarray, parent_cells: np.ndarray):
        """Fold one update's births and deaths into the phylogeny.

        newborn_* are the gathered rows for cells whose birth_update equals
        `update`; parent_cells[i] is the parent's cell index (so the parent
        genotype is looked up from the *pre-birth* cell map).
        """
        # parent genotypes resolved against the pre-update cell map
        parent_gids = np.where(parent_cells >= 0,
                               self.cell_gid[np.clip(parent_cells, 0, None)],
                               -1)
        for i, cell in enumerate(newborn_cells):
            L = int(newborn_lens[i])
            self._activate(int(cell), newborn_genomes[i, :L],
                           int(parent_gids[i]), update)
        # deaths: cells we believed occupied that are no longer alive
        dead = (self.cell_gid >= 0) & ~alive
        for cell in np.nonzero(dead)[0]:
            self._remove_unit(int(self.cell_gid[cell]), update)
            self.cell_gid[cell] = -1

    def record_stats(self, cells: np.ndarray, merit, fitness, gestation):
        """Accumulate per-genotype stat sums for reporting (cheap, optional)."""
        for c in cells:
            g = self.genotypes.get(int(self.cell_gid[c]))
            if g is not None:
                g.merit_sum += float(merit[c])
                g.fitness_sum += float(fitness[c])
                g.gestation_sum += float(gestation[c])
                g.stat_n += 1

    # -- queries ----------------------------------------------------------

    @property
    def num_genotypes(self) -> int:
        return sum(1 for g in self.genotypes.values() if g.num_units > 0)

    @property
    def num_threshold(self) -> int:
        return sum(1 for g in self.genotypes.values()
                   if g.num_units > 0 and g.threshold)

    def live_genotypes(self):
        """Iterator over genotypes with living members (stats entropy)."""
        return (g for g in self.genotypes.values() if g.num_units > 0)

    def dominant(self) -> Genotype | None:
        """Most-abundant live genotype (ref dominant genotype reporting)."""
        best = None
        for g in self.genotypes.values():
            if g.num_units > 0 and (best is None or g.num_units > best.num_units
                                    or (g.num_units == best.num_units
                                        and g.gid < best.gid)):
                best = g
        return best

    def average_depth(self) -> float:
        tot = n = 0
        for g in self.genotypes.values():
            if g.num_units > 0:
                tot += g.depth * g.num_units
                n += g.num_units
        return tot / n if n else 0.0

    def prune_extinct(self, keep_ancestry: bool = True):
        """Drop extinct genotypes not on any live lineage (memory control;
        ref keeps historic genotypes only when requested)."""
        live_anc = set()
        for g in self.genotypes.values():
            if g.num_units > 0:
                gid = g.gid
                while gid >= 0 and gid not in live_anc:
                    live_anc.add(gid)
                    gg = self.genotypes.get(gid)
                    gid = gg.parent_gid if gg else -1
        doomed = [gid for gid, g in self.genotypes.items()
                  if g.num_units == 0 and (not keep_ancestry or gid not in live_anc)]
        for gid in doomed:
            g = self.genotypes.pop(gid)
            self._by_seq.pop(g.sequence.tobytes(), None)

    # -- checkpoint serialization (utils/checkpoint.py) -------------------

    _SNAP_FIELDS = ("gid", "parent_gid", "depth", "update_born", "num_units",
                    "total_units", "last_birth_update", "update_deactivated",
                    "threshold", "merit_sum", "fitness_sum", "gestation_sum",
                    "stat_n")

    def to_snapshot(self) -> dict:
        """JSON-able snapshot of the full phylogeny (native checkpoints).
        Genome sequences ride as base64 int8 bytes; everything else is a
        plain scalar, so the round-trip is exact."""
        import base64
        return {
            "threshold": self.threshold,
            "next_id": self._next_id,
            "num_births_total": self.num_births_total,
            "cell_gid": self.cell_gid.tolist(),
            "genotypes": [
                dict({f: getattr(g, f) for f in self._SNAP_FIELDS},
                     seq=base64.b64encode(
                         np.ascontiguousarray(g.sequence, np.int8)
                         .tobytes()).decode("ascii"))
                for g in self.genotypes.values()],
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "GenotypeArbiter":
        """Rebuild an arbiter from to_snapshot output (exact inverse)."""
        import base64
        arb = cls(world_cells=len(snap["cell_gid"]),
                  threshold=int(snap["threshold"]))
        arb._next_id = int(snap["next_id"])
        arb.num_births_total = int(snap["num_births_total"])
        arb.cell_gid = np.asarray(snap["cell_gid"], np.int64)
        for rec in snap["genotypes"]:
            seq = np.frombuffer(base64.b64decode(rec["seq"]), np.int8).copy()
            kw = {f: rec[f] for f in cls._SNAP_FIELDS}
            g = Genotype(sequence=seq, **kw)
            arb.genotypes[g.gid] = g
            arb._by_seq[seq.tobytes()] = g
        return arb
