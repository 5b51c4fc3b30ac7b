"""Checkpoint-native run analytics: census, knockouts, lineage replay.

Counterpart of avida_tpu/analyze/pipeline.py.  The analyze VM
(analyze/analyzer.py) answers questions about `.spop` saves; this module
answers them about native checkpoints (utils/checkpoint.py):

  * **loader** -- the newest CRC-valid generation, falling back past
    corrupt or torn generations exactly as World.resume does (the same
    restore_candidates order and verification), rebuilding the
    population arrays and the systematics tables
    (GenotypeArbiter.from_snapshot; a checkpoint written with
    TPU_SYSTEMATICS=0 gets a content-keyed table rebuilt from the live
    population, depth restarting at 0);
  * **phenotype census** -- task profile / fitness / gestation of every
    live genotype through the batched Test CPU, content-keyed through
    systematics/test_metrics.GenomeTestMetrics, so an incremental
    refresh only evaluates genotypes it has not seen;
  * **knockout attribution** -- per-site null-instruction sweeps over the
    dominant and threshold genotypes (`knockout_profile`, shared with the
    analyze VM's ANALYZE_KNOCKOUTS);
  * **lineage replay** -- the arbiter's parent chain from the dominant
    genotype back to its root, each step recalculated, as a per-depth
    fitness / task-acquisition table.

Results go to `{"record": "analytics"}` lines in
DATA_DIR/analysis/analytics.jsonl (observability/records.append_record,
rotation-capped), to census.dat / knockout.dat / lineage.dat under
DATA_DIR/analysis/, and to DATA_DIR/analytics.prom
(observability/exporter.render_families).

Two entry points: `python -m avida_tpu_torch --analyze CKPT_DIR`
(cli_main, offline) and TPU_ANALYTICS=1 (LiveAnalytics: World.run
refreshes the census at checkpoint boundaries and at run exit; a pure
read of the state, so a run's trajectory is the same with it on or off).
The Test CPU runs on the world's device.

Module import stays numpy-only: anything that evaluates genotypes
imports the Test CPU inside the call.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from avida_tpu_torch.systematics.genotypes import GenotypeArbiter
from avida_tpu_torch.utils import checkpoint as ckpt_mod
from avida_tpu_torch.utils.output import DatFile

ANALYSIS_DIR = "analysis"
ANALYTICS_LOG = "analytics.jsonl"
ANALYTICS_METRICS_FILE = "analytics.prom"

# rotation cap for the analytics journal (records.append_record semantics)
ANALYTICS_LOG_MAX_BYTES = 16 << 20


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def tasks_mask(task_counts) -> int:
    """Bitmask with bit i set when task i was performed (environment
    task order -- bit 8 is EQU in the stock logic-9 ladder)."""
    return int(sum(1 << i for i, c in enumerate(np.asarray(task_counts))
                   if c > 0))


# ---------------------------------------------------------------------------
# table reconstruction (checkpoint or live world)
# ---------------------------------------------------------------------------

@dataclass
class RunTables:
    """Population + systematics tables reconstructed from one checkpoint
    generation (or snapshotted from a live world for the in-run census)."""
    update: int
    alive: np.ndarray             # bool[N]
    genome: np.ndarray            # int8[N, L]
    genome_len: np.ndarray        # int32[N]
    task_counts: np.ndarray | None  # int32[N, R] last-gestation counts
    arbiter: GenotypeArbiter
    path: str | None = None       # generation dir (None = live tables)
    rebuilt: bool = False         # arbiter rebuilt (no systematics sidecar)


def _rebuild_arbiter(alive, genome, genome_len, update) -> GenotypeArbiter:
    """Content-keyed genotype table from the live population (the same
    ancestry-free approximation checkpoint restore uses when the
    systematics sidecar is absent: depth/lineage restart at 0).

    Cost note: O(live cells) host work (tobytes + dict per cell).  In
    live mode with TPU_SYSTEMATICS=0 (the packed-chunk engine) this
    runs per checkpoint boundary; at production world sizes it is a
    few ms next to the save's array-write+fsync.  If it ever shows in
    a profile, dedupe rows first (np.unique over packed genome bytes)
    or cache the table and reclassify only changed cells."""
    arb = GenotypeArbiter(int(alive.shape[0]))
    for c in np.nonzero(alive)[0]:
        arb.classify_seed(int(c), genome[c, : int(genome_len[c])],
                          update=int(update))
    return arb


def tables_from_generation(path: str, manifest: dict, arrays: dict,
                           files: dict) -> RunTables:
    alive = np.asarray(arrays["state.alive"]).astype(bool)
    genome = np.asarray(arrays["state.genome"])
    genome_len = np.asarray(arrays["state.genome_len"])
    tasks = arrays.get("state.last_task_count")
    update = int(manifest["update"])
    if "systematics.json" in files:
        arb = GenotypeArbiter.from_snapshot(
            json.loads(files["systematics.json"].decode()))
        rebuilt = False
    else:
        arb = _rebuild_arbiter(alive, genome, genome_len, update)
        rebuilt = True
    return RunTables(update=update, alive=alive, genome=genome,
                     genome_len=genome_len,
                     task_counts=(None if tasks is None
                                  else np.asarray(tasks)),
                     arbiter=arb, path=path, rebuilt=rebuilt)


def load_run_tables(ckpt_dir: str, on_skip=None) -> RunTables:
    """RunTables from the newest VALID generation under `ckpt_dir`.

    Corrupt or torn generations are skipped newest-to-oldest with a
    warning (`on_skip(path, error)` when given), falling back to the
    previous retained one -- byte-for-byte the ordering and verification
    World.resume uses (restore_candidates + CRC manifest check), so the
    pipeline analyzes exactly the generation a resume would restore."""
    candidates = ckpt_mod.restore_candidates(ckpt_dir)
    if not candidates:
        raise ckpt_mod.CheckpointError(
            f"no checkpoints under {ckpt_dir!r}")
    last_err = None
    for path in candidates:
        try:
            manifest, arrays, files = ckpt_mod.read_generation(path)
        except ckpt_mod.CheckpointError as e:
            last_err = e
            if on_skip is not None:
                on_skip(path, e)
            else:
                print(f"[avida_tpu_torch] analytics: skipping corrupt "
                      f"generation {path} ({e})", file=sys.stderr)
            continue
        return tables_from_generation(path, manifest, arrays, files)
    raise ckpt_mod.CheckpointError(
        f"no valid checkpoint under {ckpt_dir!r} (last error: {last_err})")


def tables_from_world(world) -> RunTables:
    """Snapshot the live world's tables for an in-run census.  Pure
    read: no PRNG key is consumed and no state field is touched, so the
    evolved trajectory is bit-identical with analytics on or off."""
    st = world.state
    alive = _host(st.alive).astype(bool)
    genome = _host(st.genome)
    genome_len = _host(st.genome_len)
    arb = world.systematics
    rebuilt = False
    if arb is None:
        arb = _rebuild_arbiter(alive, genome, genome_len, world.update)
        rebuilt = True
    return RunTables(update=int(world.update), alive=alive, genome=genome,
                     genome_len=genome_len,
                     task_counts=_host(st.last_task_count),
                     arbiter=arb, path=None, rebuilt=rebuilt)


# ---------------------------------------------------------------------------
# cheap triage (no Test CPU)
# ---------------------------------------------------------------------------

def checkpoint_detail(path: str) -> dict:
    """Spool-triage summary of ONE generation: dominant genotype id /
    units / depth, live organism count and the tasks-held bitmask (from
    the saved per-cell last-gestation task counts) -- manifest + two
    arrays + the systematics sidecar, no sandbox evaluation."""
    with open(os.path.join(path, ckpt_mod.MANIFEST)) as f:
        manifest = json.load(f)
    out = {"update": manifest.get("update"), "live": None,
           "tasks_mask": None, "genotypes": None, "dominant_gid": None,
           "dominant_units": None, "dominant_depth": None}

    def _arr(name):
        spec = manifest.get("arrays", {}).get(name)
        if not spec:
            return None
        try:
            return np.load(os.path.join(path, spec["file"]))
        except Exception:
            return None

    alive = _arr("state.alive")
    if alive is not None:
        alive = alive.astype(bool)
        out["live"] = int(alive.sum())
        tasks = _arr("state.last_task_count")
        if tasks is not None:
            held = (tasks[alive] > 0).any(axis=0) if alive.any() \
                else np.zeros(tasks.shape[1], bool)
            out["tasks_mask"] = tasks_mask(held)
    if "systematics.json" in manifest.get("files", {}):
        try:
            with open(os.path.join(path, "systematics.json")) as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError):
            return out
        live_g = [g for g in snap.get("genotypes", ())
                  if g.get("num_units", 0) > 0]
        out["genotypes"] = len(live_g)
        if live_g:
            # same ordering as GenotypeArbiter.dominant (abundance,
            # then lowest gid)
            best = max(live_g, key=lambda g: (g["num_units"], -g["gid"]))
            out["dominant_gid"] = int(best["gid"])
            out["dominant_units"] = int(best["num_units"])
            out["dominant_depth"] = int(best["depth"])
    return out


# ---------------------------------------------------------------------------
# knockout attribution (shared with Analyzer._cmd_ANALYZE_KNOCKOUTS)
# ---------------------------------------------------------------------------

def knockout_profile(params, sequence, base_fitness, seed: int = 0,
                     device=None) -> dict:
    """Per-site knockout sweep of one genotype: replace each site with
    the null instruction (op 0, nop-A) and test viability/fitness in one
    batched Test-CPU run.  Classification thresholds are the analyze
    VM's (`ANALYZE_KNOCKOUTS`): lethal fit<=0, detrimental rel<0.95,
    neutral 0.95..1.05, beneficial rel>1.05.  Runs on `device` (the GPU
    unless named)."""
    from avida_tpu_torch.analyze.testcpu import evaluate_genomes

    seq = np.asarray(sequence, np.int8)
    # genomes longer than the buffer truncate, matching the analyze
    # VM's _padded discipline (a .spop can carry genomes wider than
    # this build's TPU_MAX_MEMORY; sweeping the loadable prefix beats
    # crashing the whole analyze script)
    seq = seq[: params.max_memory]
    L = int(len(seq))
    buf = np.zeros((L, params.max_memory), np.int8)
    for site in range(L):
        m = seq.copy()
        m[site] = 0
        buf[site, :L] = m
    r = evaluate_genomes(params, buf, np.full(L, L, np.int32), seed=seed,
                         device=device)
    fit = np.where(r.viable, r.fitness, 0.0)
    rel = fit / max(base_fitness, 1e-30)
    return {
        "length": L,
        "lethal": int((fit <= 0).sum()),
        "detrimental": int(((fit > 0) & (rel < 0.95)).sum()),
        "neutral": int(((rel >= 0.95) & (rel <= 1.05)).sum()),
        "beneficial": int((rel > 1.05).sum()),
        "rel_fitness": rel,
    }


# ---------------------------------------------------------------------------
# .dat table writers (shared by the pipeline and the analyze VM)
# ---------------------------------------------------------------------------

def _task_names(task_names, n):
    names = list(task_names or [])
    return names if len(names) == n else [f"task{i}" for i in range(n)]


def write_census_dat(path: str, rows: list, task_names=None):
    n_tasks = len(rows[0]["task_counts"]) if rows else 0
    names = _task_names(task_names, n_tasks)
    f = DatFile(path, "Avida phenotype census",
                ["Genotype ID", "Num units", "Depth", "Length", "Viable",
                 "Fitness", "Merit", "Gestation time", "Tasks mask"]
                + [n.capitalize() for n in names])
    for r in rows:
        f.write_row([r["gid"], r["num_units"], r["depth"], r["length"],
                     int(r["viable"]), r["fitness"], r["merit"],
                     r["gestation"], r["tasks_mask"]]
                    + [int(x) for x in r["task_counts"]])
    f.close()


def write_knockout_dat(path: str, rows: list):
    f = DatFile(path, "Knockout attribution",
                ["Genotype ID", "Num units", "Length", "Num lethal",
                 "Num detrimental", "Num neutral", "Num beneficial",
                 "Base fitness"])
    for r in rows:
        f.write_row([r["gid"], r["num_units"], r["length"], r["lethal"],
                     r["detrimental"], r["neutral"], r["beneficial"],
                     r["base_fitness"]])
    f.close()


def write_lineage_dat(path: str, rows: list):
    f = DatFile(path, "Dominant lineage replay (root first)",
                ["Depth", "Genotype ID", "Parent ID", "Update born",
                 "Length", "Fitness", "Gestation time", "Tasks mask",
                 "Tasks gained"])
    for r in rows:
        f.write_row([r["depth"], r["gid"], r["parent_gid"],
                     r["update_born"], r["length"], r["fitness"],
                     r["gestation"], r["tasks_mask"], r["tasks_gained"]])
    f.close()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class AnalyticsPipeline:
    """Composes the census / knockout / lineage passes over RunTables
    and routes the results through the observability spine (analytics
    runlog, .dat tables, analytics.prom).  One instance per data dir;
    the content-keyed metrics cache persists across run() calls, so the
    live incremental census only ever evaluates genotypes it has not
    seen before."""

    def __init__(self, params, task_names, data_dir: str, seed: int = 0,
                 knockout_top: int = 4, metrics=None, device=None):
        self.params = params
        self.device = device
        self.task_names = list(task_names or [])
        self.data_dir = data_dir
        self.analysis_dir = os.path.join(data_dir, ANALYSIS_DIR)
        self.seed = int(seed)
        self.knockout_top = int(knockout_top)
        if metrics is None:
            from avida_tpu_torch.systematics.test_metrics import \
                GenomeTestMetrics
            metrics = GenomeTestMetrics(params, device=device)
        self.metrics = metrics
        self.census_count = 0
        self.knockout_sweeps_total = 0
        self.knockout_sites_total = 0   # sandbox lanes spent on sweeps
        # content-keyed sweep memo (the GenomeTestMetrics pattern): a
        # stable dominant genotype must not re-pay its L-lane sweep at
        # every live-mode refresh
        self._ko_cache: dict = {}
        self.last_summary = None

    # -- pass plumbing ----------------------------------------------------

    def _live_genotypes(self, tables: RunTables) -> list:
        """Live genotypes, most-abundant first (lowest gid on ties --
        the arbiter's dominant() ordering, so row 0 IS the dominant)."""
        gs = [g for g in tables.arbiter.genotypes.values()
              if g.num_units > 0]
        gs.sort(key=lambda g: (-g.num_units, g.gid))
        return gs

    def _records_for(self, genotypes: list) -> list:
        G = len(genotypes)
        L = self.params.max_memory
        buf = np.zeros((G, L), np.int8)
        lens = np.zeros(G, np.int32)
        for i, g in enumerate(genotypes):
            n = min(g.length, L)
            buf[i, :n] = np.asarray(g.sequence, np.int8)[:n]
            lens[i] = n
        return self.metrics.get_records(buf, lens, seed=self.seed)

    # -- the three batched passes ----------------------------------------

    def census(self, tables: RunTables) -> list:
        """Phenotype census: one row per live genotype (sandbox task
        profile, fitness, gestation), most-abundant first."""
        gs = self._live_genotypes(tables)
        recs = self._records_for(gs)
        rows = []
        for g, r in zip(gs, recs):
            rows.append({
                "gid": g.gid, "num_units": g.num_units, "depth": g.depth,
                "length": g.length, "viable": r["viable"],
                "fitness": r["fitness"], "merit": r["merit"],
                "gestation": r["gestation"],
                "tasks_mask": tasks_mask(r["tasks"]),
                "task_counts": [int(x) for x in r["tasks"]],
            })
        self.census_count += 1
        return rows

    def knockouts(self, tables: RunTables) -> list:
        """Per-site knockout sweeps over the dominant + threshold
        genotypes (most-abundant first, capped at `knockout_top` --
        sweeps are L sandbox evaluations each, the expensive pass)."""
        if self.knockout_top <= 0:
            return []
        gs = self._live_genotypes(tables)
        sel = [g for g in gs if g.threshold]
        if gs and gs[0] not in sel:
            sel.insert(0, gs[0])            # dominant always swept
        sel = sel[: self.knockout_top]
        rows = []
        for g, rec in zip(sel, self._records_for(sel)):
            key = np.asarray(g.sequence, np.int8).tobytes()
            prof = self._ko_cache.get(key)
            if prof is None:
                prof = knockout_profile(self.params, g.sequence,
                                        rec["fitness"], seed=self.seed,
                                        device=self.device)
                self._ko_cache[key] = prof
                self.knockout_sweeps_total += 1
                self.knockout_sites_total += prof["length"]
            rows.append({"gid": g.gid, "num_units": g.num_units,
                         "base_fitness": rec["fitness"], **prof})
        return rows

    def lineage(self, tables: RunTables) -> list:
        """Lineage replay: the arbiter parent chain from the dominant
        genotype back to its retained root, RECALCULATEd step by step
        (cached -- ancestors seen by an earlier census cost nothing),
        emitted root-first with per-depth task acquisitions."""
        gs = self._live_genotypes(tables)
        if not gs:
            return []
        arb = tables.arbiter
        chain, seen = [], set()
        g = gs[0]
        while g is not None and g.gid not in seen:
            seen.add(g.gid)
            chain.append(g)
            g = arb.genotypes.get(g.parent_gid) if g.parent_gid >= 0 \
                else None
        chain.reverse()                     # root first
        recs = self._records_for(chain)
        rows, prev_mask = [], 0
        for depth, (g, r) in enumerate(zip(chain, recs)):
            mask = tasks_mask(r["tasks"])
            rows.append({
                "depth": depth, "gid": g.gid, "parent_gid": g.parent_gid,
                "update_born": g.update_born, "length": g.length,
                "fitness": r["fitness"], "gestation": r["gestation"],
                "tasks_mask": mask, "tasks_gained": mask & ~prev_mask,
            })
            prev_mask = mask
        return rows

    # -- composition + publication ----------------------------------------

    def run(self, tables: RunTables, knockouts: bool = True,
            lineage: bool = True, write_tables: bool = True,
            durable: bool = True) -> dict:
        """All passes over one set of tables; returns (and publishes)
        the summary: `{"record": "analytics"}` runlog line, `.dat`
        tables under DATA_DIR/analysis/ and DATA_DIR/analytics.prom."""
        ev0 = self.metrics.evaluations
        t0 = time.perf_counter()
        census_rows = self.census(tables)
        census_ms = (time.perf_counter() - t0) * 1e3
        ev_census = self.metrics.evaluations - ev0

        lineage_rows, lineage_ms = [], 0.0
        if lineage:
            t0 = time.perf_counter()
            lineage_rows = self.lineage(tables)
            lineage_ms = (time.perf_counter() - t0) * 1e3
        ev_lineage = self.metrics.evaluations - ev0 - ev_census

        ko_rows, knockout_ms = [], 0.0
        if knockouts:
            t0 = time.perf_counter()
            ko_rows = self.knockouts(tables)
            knockout_ms = (time.perf_counter() - t0) * 1e3

        dom = census_rows[0] if census_rows else None
        held = 0
        for r in census_rows:
            held |= r["tasks_mask"]
        summary = {
            "update": tables.update,
            "source": tables.path or "live",
            "organisms": int(tables.alive.sum()),
            "genotypes": len(census_rows),
            "systematics_rebuilt": bool(tables.rebuilt),
            # census/lineage genotype evaluations through the
            # content-keyed cache; knockout sweeps bypass it (one lane
            # per genome site) and are accounted separately below
            "evaluated": ev_census + ev_lineage,
            "evaluated_census": ev_census,
            "evaluated_lineage": ev_lineage,
            "evaluated_total": self.metrics.evaluations,
            "tasks_held_mask": held,
            "dominant": (None if dom is None else {
                "gid": dom["gid"], "units": dom["num_units"],
                "depth": dom["depth"], "fitness": dom["fitness"],
                "tasks_mask": dom["tasks_mask"],
            }),
            "lineage_depth": max(len(lineage_rows) - 1, 0),
            "knockout_sweeps": len(ko_rows),
            "knockout_sweeps_total": self.knockout_sweeps_total,
            "knockout_sites": sum(r["length"] for r in ko_rows),
            "knockout_sites_total": self.knockout_sites_total,
            "census_ms": round(census_ms, 3),
            "knockout_ms": round(knockout_ms, 3),
            "lineage_ms": round(lineage_ms, 3),
        }
        if write_tables:
            os.makedirs(self.analysis_dir, exist_ok=True)
            write_census_dat(os.path.join(self.analysis_dir, "census.dat"),
                             census_rows, self.task_names)
            if lineage:
                write_lineage_dat(
                    os.path.join(self.analysis_dir, "lineage.dat"),
                    lineage_rows)
            if knockouts and self.knockout_top > 0:
                write_knockout_dat(
                    os.path.join(self.analysis_dir, "knockout.dat"),
                    ko_rows)
        self.publish(summary, durable=durable)
        self.last_summary = summary
        return summary

    def publish(self, summary: dict, durable: bool = True):
        """Route one summary through the observability spine."""
        from avida_tpu_torch.observability.exporter import write_metrics
        from avida_tpu_torch.observability.records import append_record

        os.makedirs(self.analysis_dir, exist_ok=True)
        append_record(os.path.join(self.analysis_dir, ANALYTICS_LOG),
                      dict({"record": "analytics",
                            "time": round(time.time(), 3)}, **summary),
                      max_bytes=ANALYTICS_LOG_MAX_BYTES)
        write_metrics(os.path.join(self.data_dir, ANALYTICS_METRICS_FILE),
                      render_analytics(summary), durable=durable)


def render_analytics(summary: dict) -> str:
    """analytics.prom exposition text (exporter.render_families)."""
    from avida_tpu_torch.observability.exporter import render_families

    dom = summary.get("dominant") or {}
    fams = [
        ("avida_analytics_census_update", "gauge",
         "update number the last census describes", summary["update"]),
        ("avida_analytics_census_genotypes", "gauge",
         "live genotypes scored by the last census",
         summary["genotypes"]),
        ("avida_analytics_genotypes_evaluated_total", "counter",
         "genotype evaluations run in the Test-CPU sandbox by the "
         "census/lineage passes (knockout lanes counted separately)",
         summary["evaluated_total"]),
        ("avida_analytics_knockout_sweeps_total", "counter",
         "per-site knockout sweeps completed",
         summary["knockout_sweeps_total"]),
        ("avida_analytics_knockout_sites_total", "counter",
         "sandbox lanes spent on knockout sweeps (one per genome site)",
         summary.get("knockout_sites_total", 0)),
        ("avida_analytics_tasks_held_mask", "gauge",
         "bitmask of tasks any live genotype performs (bit 8 = EQU)",
         summary["tasks_held_mask"]),
        ("avida_analytics_dominant_genotype_id", "gauge",
         "dominant genotype id (-1 when the world is empty)",
         dom.get("gid", -1)),
        ("avida_analytics_dominant_fitness", "gauge",
         "dominant genotype sandbox fitness", dom.get("fitness", 0.0)),
        ("avida_analytics_dominant_lineage_depth", "gauge",
         "phylogenetic depth of the dominant genotype",
         dom.get("depth", 0)),
        ("avida_analytics_dominant_tasks_mask", "gauge",
         "tasks the dominant genotype performs",
         dom.get("tasks_mask", 0)),
        ("avida_analytics_heartbeat_timestamp_seconds", "gauge",
         "unix time of the last analytics export",
         round(time.time(), 3)),
    ]
    return render_families(fams)


# ---------------------------------------------------------------------------
# live mode (TPU_ANALYTICS=1): the in-run incremental census
# ---------------------------------------------------------------------------

class LiveAnalytics:
    """In-run analytics for World.run: an incremental census (plus the
    dominant-lineage replay) refreshed at checkpoint boundaries and at
    run exit, so the heartbeat answer to "what evolved?" is never staler
    than one checkpoint interval.  Knockout sweeps are off by default
    (TPU_ANALYTICS_KNOCKOUT_TOP opts in -- they cost L evaluations per
    genotype).  refresh() never raises: a broken analytics pass must not
    take down the run it is observing, and it never touches world state
    or PRNG keys, so trajectories are bit-identical with analytics on or
    off."""

    def __init__(self, world):
        cfg = world.cfg
        self.pipeline = AnalyticsPipeline(
            world.params, world.environment.task_names(), world.data_dir,
            seed=int(cfg.get("TPU_ANALYTICS_SEED", 0)),
            knockout_top=int(cfg.get("TPU_ANALYTICS_KNOCKOUT_TOP", 0)),
            device=world.device)

    def refresh(self, world, durable: bool = False):
        from avida_tpu_torch.observability.runlog import emit_event
        if world.state is None:
            return
        try:
            tables = tables_from_world(world)
            self.pipeline.run(
                tables, knockouts=self.pipeline.knockout_top > 0,
                durable=durable)
        except Exception as e:          # noqa: BLE001 -- observability
            # must never take down the run it observes
            emit_event(world, "analytics_failed", error=str(e))


# ---------------------------------------------------------------------------
# CLI (python -m avida_tpu_torch --analyze CKPT_DIR)
# ---------------------------------------------------------------------------

def _peek_state_shape(ckpt_dir: str):
    """(num_cells, max_memory) of the newest generation whose manifest
    parses -- a cheap peek (no CRC sweep) used only to default
    TPU_MAX_MEMORY so the Test CPU's genome buffer matches the archived
    run's."""
    for path in ckpt_mod.restore_candidates(ckpt_dir):
        try:
            with open(os.path.join(path, ckpt_mod.MANIFEST)) as f:
                manifest = json.load(f)
            shape = manifest["arrays"]["state.tape"]["shape"]
            return int(shape[0]), int(shape[1])
        except (OSError, json.JSONDecodeError, KeyError, IndexError,
                TypeError, ValueError):
            continue
    return None


def format_summary(summary: dict) -> str:
    """Human-readable digest of one analytics summary."""
    dom = summary.get("dominant")
    held = summary.get("tasks_held_mask", 0)
    lines = [
        f"census      update {summary['update']}: "
        f"{summary['organisms']} organisms, "
        f"{summary['genotypes']} genotypes "
        f"({summary.get('evaluated_census', summary['evaluated'])} "
        f"newly evaluated)",
        f"tasks held  {held:#x} ({bin(held).count('1')} tasks)",
    ]
    if dom:
        lines.append(
            f"dominant    gid {dom['gid']} x{dom['units']}, "
            f"depth {dom['depth']}, fitness {dom['fitness']:.4g}, "
            f"tasks {dom['tasks_mask']:#x}")
    lines.append(
        f"lineage     {summary['lineage_depth']} steps replayed; "
        f"knockouts {summary['knockout_sweeps']} sweep(s)")
    if summary.get("systematics_rebuilt"):
        lines.append("note        no systematics sidecar: genotype table "
                     "rebuilt from live state (depth restarts at 0)")
    return "\n".join(lines)


def cli_main(ckpt_dir: str, config_dir=None, overrides=(), data_dir=None,
             verbose: bool = False, knockout_top: int = 4,
             census_only: bool = False, seed: int = 0, device=None) -> int:
    """Offline checkpoint-native analytics over an archived run.  No
    World.run: the World instance below only resolves config /
    instruction set / environment the way the run did; the Test CPU runs
    on its device (the GPU unless `device` names another)."""
    from avida_tpu_torch.__main__ import EXIT_CKPT

    overrides = list(overrides)
    shape = _peek_state_shape(ckpt_dir)
    if shape is not None and not any(n == "TPU_MAX_MEMORY"
                                     for n, _ in overrides):
        overrides.append(("TPU_MAX_MEMORY", shape[1]))
    if data_dir is None:
        # fleet fault-domain layout (SPOOL/<job>/{data,ck}): analyzing
        # <job>/ck lands the results next to the run's own outputs
        sib = os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)),
                           "data")
        if os.path.isdir(sib):
            data_dir = sib

    from avida_tpu_torch.world import World
    world = World(config_dir=config_dir, overrides=overrides,
                  data_dir=data_dir, device=device)

    def on_skip(path, err):
        print(f"[avida_tpu_torch] analytics: skipping corrupt generation "
              f"{path} ({err}); falling back", file=sys.stderr)

    try:
        tables = load_run_tables(ckpt_dir, on_skip=on_skip)
    except ckpt_mod.CheckpointError as e:
        print(f"[avida_tpu_torch] analyze failed: {e}", file=sys.stderr)
        return EXIT_CKPT
    if tables.genome.shape[1] != world.params.max_memory:
        print(f"[avida_tpu_torch] checkpoint genome width "
              f"{tables.genome.shape[1]} != configured TPU_MAX_MEMORY "
              f"{world.params.max_memory}; pass the run's original "
              f"config (-c/-set)", file=sys.stderr)
        return 2

    pipe = AnalyticsPipeline(world.params, world.environment.task_names(),
                             world.data_dir, seed=seed,
                             knockout_top=knockout_top, device=world.device)
    summary = pipe.run(tables, knockouts=not census_only)
    print(format_summary(summary))
    if verbose:
        names = "census,lineage" + ("" if census_only else ",knockout")
        print(f"tables      {pipe.analysis_dir}/{{{names}}}.dat, "
              + os.path.join(world.data_dir, ANALYTICS_METRICS_FILE))
    return 0
