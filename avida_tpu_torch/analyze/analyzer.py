"""Analyze mode: the offline genotype post-processing VM.

Counterpart of avida_tpu/analyze/analyzer.py (cAnalyze, avida-core
source/analyze/cAnalyze.cc, commands registered at cc:11205-11330).  Every
batch operation that needs fitness data feeds the whole batch through the
lockstep Test CPU at once (analyze/testcpu.py), on the analyzer's device
(the GPU unless the caller names another).  The .dat files it writes are
the reference's, byte for byte.

Supported commands (the working core of the reference set; the registry
pattern makes additions one-liners):
  LOAD <file.spop>          load genotypes into the current batch
  LOAD_SEQUENCE <seq>       load one genome from its letter sequence
  SET_BATCH <i> / DUPLICATE <from> [<to>] / PURGE_BATCH [<i>]
  RECALCULATE               run the batch through the Test CPU
  FILTER <field> <op> <value>   keep genotypes matching (e.g. fitness > 0)
  FIND_GENOTYPE [num_cpus|total_cpus|fitness]   keep the best genotype
  DETAIL <file> [fields...] write a genotype table (.dat format)
  TRACE [dir]               per-cycle hardware trace of each genotype
  LANDSCAPE [file]          one-step mutational landscape of the batch
  ANALYZE_KNOCKOUTS [file]  per-site knockout viability/fitness
  CENSUS [file]             pipeline-backed phenotype-census table of
                            the batch (task profile / fitness /
                            gestation per genotype; analyze/pipeline.py)
  LINEAGE [file [field]]    pipeline-backed lineage replay: reduce to
                            the ancestral lineage (FIND_LINEAGE),
                            RECALCULATE each step, write the per-depth
                            fitness/task-acquisition table
  VERBOSE / SYSTEM <cmd>    utility commands
"""

from __future__ import annotations

import os
import shlex

import numpy as np

from avida_tpu_torch.analyze.testcpu import evaluate_genomes
from avida_tpu_torch.utils import spop as spop_mod
from avida_tpu_torch.utils.output import DatFile


class AnalyzeGenotype:
    """Batch entry (ref cAnalyzeGenotype)."""

    def __init__(self, sequence, gid=0, name="", num_cpus=1, total_cpus=1):
        self.sequence = np.asarray(sequence, np.int8)
        self.id = gid
        self.name = name or f"org-{gid}"
        self.num_cpus = num_cpus          # live organism count at save
        self.total_cpus = total_cpus
        # filled by RECALCULATE
        self.viable = None
        self.fitness = 0.0
        self.merit = 0.0
        self.gestation_time = 0
        self.copied_size = 0
        self.executed_size = 0
        self.task_counts = None

    @property
    def length(self):
        return len(self.sequence)


class Analyzer:
    """Interpret an analyze.cfg program (ref cAnalyze::RunFile)."""

    def __init__(self, params, instset, data_dir="data", verbose=False,
                 device=None):
        self.params = params
        self.device = device
        self.instset = instset
        self.data_dir = data_dir
        self.batches: dict[int, list[AnalyzeGenotype]] = {}
        self.current = 0
        self.verbose = verbose
        self._next_id = 1

    @property
    def batch(self) -> list[AnalyzeGenotype]:
        return self.batches.setdefault(self.current, [])

    # ---- program driver -------------------------------------------------

    def run_file(self, path: str):
        with open(path) as f:
            self.run_lines(f.read().splitlines())

    def run_lines(self, lines):
        for raw in lines:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            self.run_command(line)

    def run_command(self, line: str):
        tokens = shlex.split(line)
        cmd, args = tokens[0].upper(), tokens[1:]
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            raise ValueError(f"unknown analyze command {cmd!r}")
        if self.verbose:
            print(f"analyze: {line}")
        return handler(args)

    # ---- batch management ----------------------------------------------

    def _cmd_SET_BATCH(self, args):
        self.current = int(args[0])

    def _cmd_DUPLICATE(self, args):
        src = int(args[0])
        dst = int(args[1]) if len(args) > 1 else self.current
        self.batches.setdefault(dst, []).extend(
            AnalyzeGenotype(g.sequence.copy(), self._take_id(), g.name,
                            g.num_cpus, g.total_cpus)
            for g in self.batches.get(src, []))

    def _cmd_PURGE_BATCH(self, args):
        idx = int(args[0]) if args else self.current
        self.batches[idx] = []

    def _take_id(self):
        i = self._next_id
        self._next_id += 1
        return i

    # ---- loading --------------------------------------------------------

    def _cmd_LOAD(self, args):
        orgs = spop_mod.load_population(args[0], self.params, None)
        seen = {}
        for o in orgs:
            key = o["genome"].tobytes()
            if key in seen:
                seen[key].num_cpus += 1
                seen[key].total_cpus += 1
            else:
                g = AnalyzeGenotype(o["genome"], self._take_id())
                g.src_id = o.get("id", -1)
                g.parent_src = o.get("parent", -1)
                g.depth = o.get("depth", -1)
                seen[key] = g
                self.batch.append(g)

    def _cmd_LOAD_SEQUENCE(self, args):
        seq = spop_mod._string_to_seq(args[0])
        self.batch.append(AnalyzeGenotype(seq, self._take_id()))

    # ---- evaluation ------------------------------------------------------

    def _padded(self, genotypes):
        L = self.params.max_memory
        G = len(genotypes)
        buf = np.zeros((G, L), np.int8)
        lens = np.zeros(G, np.int32)
        for i, g in enumerate(genotypes):
            n = min(g.length, L)
            buf[i, :n] = g.sequence[:n]
            lens[i] = n
        return buf, lens

    def _cmd_RECALCULATE(self, args):
        if not self.batch:
            return
        buf, lens = self._padded(self.batch)
        r = evaluate_genomes(self.params, buf, lens,
                             device=self.device)
        for i, g in enumerate(self.batch):
            g.viable = bool(r.viable[i])
            g.fitness = float(r.fitness[i])
            g.merit = float(r.merit[i])
            g.gestation_time = int(r.gestation_time[i])
            g.copied_size = int(r.copied_size[i])
            g.executed_size = int(r.executed_size[i])
            g.task_counts = np.asarray(r.task_counts[i])

    # ---- filtering -------------------------------------------------------

    _OPS = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
            ">": lambda a, b: a > b, "<": lambda a, b: a < b,
            ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b}

    def _cmd_FILTER(self, args):
        field, op, value = args[0], args[1], float(args[2])
        f = self._OPS[op]
        self.batches[self.current] = [
            g for g in self.batch if f(float(getattr(g, field)), value)]

    def _cmd_FIND_GENOTYPE(self, args):
        if not self.batch:
            return
        crit = args[0] if args else "num_cpus"
        best = max(self.batch, key=lambda g: getattr(g, crit))
        self.batches[self.current] = [best]

    # ---- output ----------------------------------------------------------

    _DETAIL_DEFAULT = ["id", "fitness", "merit", "gestation_time", "length"]

    def _cmd_DETAIL(self, args):
        fname = args[0] if args else "detail.dat"
        fields = args[1:] if len(args) > 1 else self._DETAIL_DEFAULT
        f = DatFile(os.path.join(self.data_dir, fname),
                    "Avida analyze details", fields)
        for g in self.batch:
            row = []
            for fd in fields:
                if fd == "sequence":
                    row.append(spop_mod._seq_to_string(g.sequence))
                elif fd == "viable":
                    row.append(int(bool(g.viable)))
                else:
                    row.append(getattr(g, fd))
            f.write_row(row)
        f.close()

    def _cmd_TRACE(self, args):
        from avida_tpu_torch.analyze.trace import trace_genome
        outdir = os.path.join(self.data_dir, args[0] if args else "trace")
        os.makedirs(outdir, exist_ok=True)
        for g in self.batch:
            path = os.path.join(outdir, f"org-{g.id}.trace")
            trace_genome(self.params, self.instset, g.sequence, path,
                         device=self.device)

    # ---- genetics --------------------------------------------------------

    def _cmd_LANDSCAPE(self, args):
        """One-step mutational landscape of each batch genotype
        (ref cLandscape::Process, main/cLandscape.cc)."""
        fname = args[0] if args else "landscape.dat"
        f = DatFile(os.path.join(self.data_dir, fname), "Mutational landscape",
                    ["genotype id", "base fitness", "num mutants",
                     "frac lethal", "frac detrimental", "frac neutral",
                     "frac beneficial", "average fitness",
                     "max mutant fitness"])
        ni = self.params.num_insts
        for g in self.batch:
            base = self._recalc_one(g)
            L = g.length
            muts = []
            for site in range(L):
                for op in range(ni):
                    if op == g.sequence[site]:
                        continue
                    m = g.sequence.copy()
                    m[site] = op
                    muts.append(m)
            buf, lens = self._padded(
                [AnalyzeGenotype(m) for m in muts])
            r = evaluate_genomes(self.params, buf, lens,
                                 device=self.device)
            fit = np.where(r.viable, r.fitness, 0.0)
            base_f = max(base, 1e-30)
            rel = fit / base_f
            f.write_row([
                g.id, base, len(muts),
                float((fit <= 0).mean()),
                float(((fit > 0) & (rel < 0.95)).mean()),
                float(((rel >= 0.95) & (rel <= 1.05)).mean()),
                float((rel > 1.05).mean()),
                float(fit.mean()), float(fit.max())])
        f.close()

    def _cmd_ANALYZE_KNOCKOUTS(self, args):
        """Replace each site with the null instruction and test viability
        (ref cAnalyze KNOCKOUT machinery; classification shared with the
        checkpoint-native pipeline via pipeline.knockout_profile)."""
        from avida_tpu_torch.analyze.pipeline import knockout_profile
        fname = args[0] if args else "knockouts.dat"
        f = DatFile(os.path.join(self.data_dir, fname), "Knockout analysis",
                    ["genotype id", "length", "num lethal", "num detrimental",
                     "num neutral", "num beneficial"])
        for g in self.batch:
            base = self._recalc_one(g)
            prof = knockout_profile(self.params, g.sequence, base,
                                    device=self.device)
            # length column = SITES SWEPT (knockout_profile truncates
            # genomes wider than the memory buffer), so the four class
            # counts always partition it
            f.write_row([
                g.id, prof["length"], prof["lethal"],
                prof["detrimental"], prof["neutral"],
                prof["beneficial"]])
        f.close()

    def _cmd_CENSUS(self, args):
        """CENSUS [file]: pipeline-backed phenotype-census table of the
        current batch (analyze/pipeline.write_census_dat -- the same
        schema `--analyze CKPT_DIR` writes, with num_cpus standing in
        for live units and src depth when the batch came from a .spop)."""
        from avida_tpu_torch.analyze.pipeline import (tasks_mask,
                                                      write_census_dat)
        fname = args[0] if args else "census.dat"
        self._recalc_missing()
        rows = []
        for g in self.batch:
            tasks = (np.asarray(g.task_counts)
                     if g.task_counts is not None
                     else np.zeros(self.params.num_reactions, np.int64))
            rows.append({
                "gid": g.id, "num_units": g.num_cpus,
                "depth": getattr(g, "depth", -1), "length": g.length,
                "viable": bool(g.viable), "fitness": g.fitness,
                "merit": g.merit, "gestation": g.gestation_time,
                "tasks_mask": tasks_mask(tasks),
                "task_counts": [int(x) for x in tasks],
            })
        write_census_dat(os.path.join(self.data_dir, fname), rows)

    def _cmd_LINEAGE(self, args):
        """LINEAGE [file [field]]: pipeline-backed lineage replay over
        the loaded batch -- FIND_LINEAGE's parent-link walk, then a
        RECALCULATE of every step and the per-depth fitness /
        task-acquisition table (analyze/pipeline.write_lineage_dat)."""
        from avida_tpu_torch.analyze.pipeline import (tasks_mask,
                                                      write_lineage_dat)
        fname = args[0] if args else "lineage.dat"
        self._cmd_FIND_LINEAGE(args[1:2])
        self._recalc_missing()
        rows, prev_mask = [], 0
        for depth, g in enumerate(self.batch):       # root first
            tasks = (np.asarray(g.task_counts)
                     if g.task_counts is not None
                     else np.zeros(self.params.num_reactions, np.int64))
            mask = tasks_mask(tasks)
            # id columns stay in ONE id space: the .spop source ids when
            # the batch was LOADed (parent_src lives there), else the
            # batch ids (parent then -1) -- so Parent ID always joins
            # against a Genotype ID row
            src = getattr(g, "src_id", -1)
            rows.append({
                "depth": depth, "gid": src if src >= 0 else g.id,
                "parent_gid": (getattr(g, "parent_src", -1)
                               if src >= 0 else -1),
                "update_born": -1, "length": g.length,
                "fitness": g.fitness, "gestation": g.gestation_time,
                "tasks_mask": mask, "tasks_gained": mask & ~prev_mask,
            })
            prev_mask = mask
        write_lineage_dat(os.path.join(self.data_dir, fname), rows)

    def _cmd_ANALYZE_MODULARITY(self, args):
        """Functional modularity via site knockouts
        (cModularityAnalysis::CalcFunctionalModularity,
        analyze/cModularityAnalysis.cc:54-240): null each site, batch-test
        through the Test CPU, and mark site x task entries where the
        knockout completely removes a task the base genotype performs.
        Columns follow the reference's ADD_GDATA list (cc:42-50, scalar
        subset)."""
        fname = args[0] if args else "modularity.dat"
        f = DatFile(
            os.path.join(self.data_dir, fname), "Modularity analysis",
            ["genotype id", "Number of Tasks Performed",
             "Number of Instructions Involved in Tasks",
             "Proportion of Sites in Tasks",
             "Average Number of Tasks Per Site",
             "Average Number of Sites Per Task",
             "Average Task Overlap"])
        nop = 0
        for g in self.batch:
            buf, lens = self._padded([g])
            rbase = evaluate_genomes(self.params, buf, lens,
                                     device=self.device)
            base = float(rbase.fitness[0]) if bool(rbase.viable[0]) else 0.0
            base_tasks = rbase.task_counts[0] > 0
            if base <= 0 or not base_tasks.any():
                f.write_row([g.id, 0, 0, 0.0, 0.0, 0.0, 0.0])
                continue
            L = g.length
            kos = []
            for site in range(L):
                m = g.sequence.copy()
                m[site] = nop
                kos.append(AnalyzeGenotype(m))
            buf, lens = self._padded(kos)
            r = evaluate_genomes(self.params, buf, lens,
                                 device=self.device)
            fit = np.where(r.viable, r.fitness, 0.0)
            # mod_matrix[task, site] = 1 iff the knockout (still viable)
            # FULLY removes a task the base does (binary criterion, cc:119)
            tdone = r.task_counts > 0                       # [L, R]
            mod = (base_tasks[None, :] & ~tdone
                   & (fit > 0)[:, None]).T                  # [R, L]
            sites_per_task = mod.sum(axis=1)
            tasks_per_site = mod.sum(axis=0)
            total_task = int((sites_per_task > 0).sum())
            total_inst = int((tasks_per_site > 0).sum())
            total_all = int(mod.sum())
            # average task overlap (cc:157-176)
            sum_overlap = 0.0
            if total_task > 1:
                ov = (mod.astype(np.int64) @ mod.T.astype(np.int64))
                for i in range(mod.shape[0]):
                    if ov[i, i]:
                        other = int(ov[i].sum() - ov[i, i])
                        sum_overlap += other / (ov[i, i] * (total_task - 1))
            f.write_row([
                g.id, total_task, total_inst,
                total_inst / max(L, 1),
                (total_all / total_inst) if total_inst else 0.0,
                (total_all / total_task) if total_task else 0.0,
                (sum_overlap / total_task) if total_task else 0.0])
        f.close()

    def _recalc_missing(self):
        """RECALCULATE only when some batch member has never been
        scored: `RECALCULATE; CENSUS; LINEAGE` scripts must not pay the
        batched gestation sweep three times over the same genotypes."""
        if any(g.task_counts is None for g in self.batch):
            self._cmd_RECALCULATE([])

    def _recalc_one(self, g) -> float:
        buf, lens = self._padded([g])
        r = evaluate_genomes(self.params, buf, lens,
                             device=self.device)
        g.fitness = float(r.fitness[0])
        g.viable = bool(r.viable[0])
        return g.fitness if g.viable else 0.0

    # ---- misc ------------------------------------------------------------

    def _cmd_ALIGN(self, args):
        """Progressive alignment of the batch against its first genotype
        (ref cAnalyze::CommandAlign, cAnalyze.cc: gaps written as "_").
        Stores g.alignment (letter sequence with gaps); DETAIL can emit
        the `alignment` field afterwards."""
        if not self.batch:
            return
        ref_seq = self.batch[0].sequence

        def lcs_align(a, b):
            # O(len(a)*len(b)) LCS table; emits aligned letter strings
            la, lb = len(a), len(b)
            D = np.zeros((la + 1, lb + 1), np.int32)
            for i in range(la - 1, -1, -1):
                for j in range(lb - 1, -1, -1):
                    best = max(D[i + 1][j + 1] + (1 if a[i] == b[j] else 0),
                               D[i + 1][j], D[i][j + 1])
                    D[i][j] = best
            # traceback
            out_a, out_b = [], []
            i = j = 0
            while i < la and j < lb:
                if a[i] == b[j] and D[i][j] == D[i + 1][j + 1] + 1:
                    out_a.append(a[i]); out_b.append(b[j]); i += 1; j += 1
                elif D[i][j] == D[i + 1][j]:
                    out_a.append(a[i]); out_b.append(-1); i += 1
                else:
                    out_a.append(-1); out_b.append(b[j]); j += 1
            while i < la:
                out_a.append(a[i]); out_b.append(-1); i += 1
            while j < lb:
                out_a.append(-1); out_b.append(b[j]); j += 1
            return out_a, out_b

        def to_str(seq):
            return "".join("_" if x < 0 else spop_mod._seq_to_string(
                np.asarray([x], np.int8)) for x in seq)

        for g in self.batch:
            ra, rb = lcs_align(list(ref_seq), list(g.sequence))
            g.alignment = to_str(rb)
        self.batch[0].alignment = to_str(list(ref_seq))

    def _cmd_MAP_MUTATIONS(self, args):
        """Per-site x per-instruction mutant fitness map for each batch
        genotype (ref cAnalyze::CommandMapMutations): one file per
        genotype, row = site, column = replacement instruction, value =
        fitness relative to the base genotype."""
        outdir = os.path.join(self.data_dir, args[0] if args else "mutmap")
        os.makedirs(outdir, exist_ok=True)
        ni = self.params.num_insts
        for g in self.batch:
            base = max(self._recalc_one(g), 1e-30)
            L = g.length
            muts = []
            for site in range(L):
                for op in range(ni):
                    m = g.sequence.copy()
                    m[site] = op
                    muts.append(AnalyzeGenotype(m))
            buf, lens = self._padded(muts)
            r = evaluate_genomes(self.params, buf, lens,
                                 device=self.device)
            fit = np.where(r.viable, r.fitness, 0.0).reshape(L, ni) / base
            with open(os.path.join(outdir, f"mut-map-{g.id}.dat"), "w") as f:
                f.write("# Mutation map: rows = sites, cols = instructions; "
                        "entries = mutant fitness / base fitness\n")
                for site in range(L):
                    f.write(" ".join(f"{fit[site, o]:.4f}"
                                     for o in range(ni)) + "\n")

    def _cmd_FIND_LINEAGE(self, args):
        """Reduce the batch to the ancestral lineage of the chosen
        genotype (ref cAnalyze::CommandFindLineage): walk parent links
        (from the loaded .spop systematics columns) from the best
        genotype back to the root."""
        if not self.batch:
            return
        field = args[0] if args else "num_cpus"
        best = max(self.batch,
                   key=lambda g: getattr(g, field, 0) or 0)
        by_src = {getattr(g, "src_id", -1): g for g in self.batch}
        lineage = []
        cur = best
        seen = set()
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            lineage.append(cur)
            cur = by_src.get(getattr(cur, "parent_src", -1))
        self.batch[:] = lineage[::-1]        # root first

    def _cmd_RECOMBINE(self, args):
        """Cross consecutive batch pairs with one-region swap (ref
        cAnalyze::CommandRecombine; region-swap semantics shared with
        cBirthChamber::RegionSwap): appends the recombinants to the
        batch."""
        reps = int(args[0]) if args else 1
        # advance the stream per invocation (the reference draws from the
        # advancing global RNG; a fixed seed would repeat crossover points)
        self._recomb_seed = getattr(self, "_recomb_seed", 0) + 1
        rng = np.random.default_rng(self._recomb_seed)
        out = []
        for _ in range(reps):
            for i in range(0, len(self.batch) - 1, 2):
                a = self.batch[i].sequence
                b = self.batch[i + 1].sequence
                la, lb = len(a), len(b)
                f0, f1 = sorted(rng.random(2))
                s0, e0 = int(f0 * la), int(f1 * la)
                s1, e1 = int(f0 * lb), int(f1 * lb)
                child = np.concatenate([a[:s0], b[s1:e1], a[e0:]])
                if len(child) >= self.params.min_genome_len and \
                        len(child) <= self.params.max_memory:
                    out.append(AnalyzeGenotype(child, self._take_id()))
        self.batch.extend(out)

    def _cmd_VERBOSE(self, args):
        self.verbose = not args or args[0] not in ("0", "off")

    def _cmd_SYSTEM(self, args):
        os.system(" ".join(args))
