"""Self-documenting .dat output files.

Reproduces the reference's data-file format (Avida::Output::File,
avida-core/source/output/File.cc:102-212: `#` header with numbered column
descriptions, then space-separated rows) for the standard print actions
(PrintAverageData / PrintCountData / PrintTasksData / PrintTimeData /
PrintDominantData / PrintResourceData / PrintFitnessData /
PrintStatsData, and the DatFile under PrintData, the histograms,
tasks_exe.dat and tasks_quality.dat, from the
244-action print library, avida-core/source/actions/PrintActions.cc); the
counterpart of avida_tpu/utils/output.py.
"""

from __future__ import annotations

import contextlib
import os
import time

# Resume continuity (World.resume -> World._file): inside this context,
# opening a DatFile whose path already holds data APPENDS instead of
# truncating, so a checkpoint-resumed run extends the preempted run's
# .dat rows rather than erasing them.  Depth-counted so nested opens
# behave; fresh files still get their header block.
_APPEND_EXISTING = 0


@contextlib.contextmanager
def append_existing():
    global _APPEND_EXISTING
    _APPEND_EXISTING += 1
    try:
        yield
    finally:
        _APPEND_EXISTING -= 1


def trim_dat_rows(data_dir: str, max_update: int):
    """Resume continuity, half two: drop data rows PAST the restored
    update from every .dat file under data_dir, so appending after a
    checkpoint restore never duplicates updates (a crash that outran the
    last auto-save, or a CRC fallback to an older generation, leaves
    rows newer than the restored state on disk).  The cutoff is STRICT
    (drop rows >= max_update): checkpoints are written before the
    restored update's events fire, so the resumed run re-emits the row
    labeled max_update itself.  Best-effort column convention: the
    standard print actions all emit the update as the first column;
    rows whose first token is non-numeric are kept.  Rewrites are
    atomic (tmp + rename)."""
    if not os.path.isdir(data_dir):
        return
    for fname in os.listdir(data_dir):
        if not fname.endswith(".dat"):
            continue
        path = os.path.join(data_dir, fname)
        with open(path) as f:
            lines = f.readlines()
        kept = []
        dropped = 0
        for line in lines:
            t = line.split()
            if not t or line.startswith("#"):
                kept.append(line)
                continue
            try:
                u = float(t[0])
            except ValueError:
                kept.append(line)
                continue
            if u < max_update:
                kept.append(line)
            else:
                dropped += 1
        if dropped:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.writelines(kept)
            os.replace(tmp, path)


class DatFile:
    def __init__(self, path: str, title: str, col_descrs: list,
                 preamble: list | None = None, append: bool = False):
        """append=True (a second World.run on the same world, a resumed
        run) or an enclosing append_existing() extends a non-empty
        existing file instead of truncating it."""
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if (append or _APPEND_EXISTING) and os.path.exists(path) \
                and os.path.getsize(path) > 0:
            self._f = open(path, "a")
            return
        self._f = open(path, "w")
        self._f.write(f"# {title}\n")
        self._f.write(f"# {time.asctime()}\n")
        for line in (preamble or []):
            self._f.write(f"# {line}\n")
        for i, d in enumerate(col_descrs, 1):
            self._f.write(f"# {i:2d}: {d}\n")
        self._f.write("\n")

    def write_row(self, values):
        def fmt(v):
            if isinstance(v, float):
                if v == int(v) and abs(v) < 1e15:
                    return str(int(v))
                return f"{v:g}"
            return str(v)
        self._f.write(" ".join(fmt(v) for v in values) + " \n")
        self._f.flush()

    def close(self):
        self._f.close()


def open_average_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "average.dat"), "Avida Average Data",
        ["Update", "Merit", "Gestation Time", "Fitness", "Repro Rate?",
         "(deprecated) Size", "Copied Size", "Executed Size",
         "(deprecated) Abundance",
         "Proportion of organisms that gave birth in this update",
         "Proportion of Breed True Organisms", "(deprecated) Genotype Depth",
         "Generation", "Neutral Metric", "Lineage Label",
         "True Replication Rate (based on births/update, time-averaged)"], append=append)


def open_count_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "count.dat"), "Avida count data",
        ["update", "number of insts executed this update",
         "number of organisms", "number of different genotypes",
         "number of different threshold genotypes",
         "(deprecated) number of different species",
         "(deprecated) number of different threshold species",
         "(deprecated) number of different lineages",
         "number of births in this update", "number of deaths in this update",
         "number of breed true", "number of breed true organisms?",
         "number of no-birth organisms", "number of single-threaded organisms",
         "number of multi-threaded organisms", "number of modified organisms"], append=append)


def open_tasks_dat(data_dir: str, task_names: list, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "tasks.dat"), "Avida tasks data",
        ["Update"] + [t.capitalize() for t in task_names],
        preamble=["First column gives the current update, next columns give the number",
                  "of organisms that have the particular task as a component of their merit"],
        append=append)


def open_fitness_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "fitness.dat"), "Avida Fitness Data",
        ["Update", "Avg Generation", "Average Fitness", "Maximum Fitness",
         "Number of organisms"], append=append)


def open_stats_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "stats.dat"), "Generic Statistics Data",
        ["Update", "Average creature age", "Genotype entropy",
         "Average gestation time", "Number of genotypes",
         "Dominant genotype abundance"], append=append)


def open_resource_dat(data_dir: str, resource_names: list,
                      append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "resource.dat"), "Avida resource data",
        ["Update", "Avida time"] + [f"{n} resource" for n in resource_names],
        preamble=["First columns give the current update and time, next columns give",
                  "the quantity of the particular resource"],
        append=append)


def open_time_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "time.dat"), "Avida time data",
        ["update", "avida time", "average generation", "num_executed?"], append=append)


def open_dominant_dat(data_dir: str, append: bool = False) -> DatFile:
    return DatFile(
        os.path.join(data_dir, "dominant.dat"), "Avida Dominant Data",
        ["Update", "Average Merit of the Dominant Genotype",
         "Average Gestation Time of the Dominant Genotype",
         "Average Fitness of the Dominant Genotype",
         "Repro Rate?", "Size of Dominant Genotype",
         "Copied Size of Dominant Genotype",
         "Executed Size of Dominant Genotype", "Abundance of Dominant Genotype",
         "Number of Births", "Number of Dominant Breed True?",
         "Dominant Gene Depth", "Dominant Breed In?",
         "Max Fitness?", "Genotype ID of Dominant Genotype",
         "Name of the Dominant Genotype"], append=append)
