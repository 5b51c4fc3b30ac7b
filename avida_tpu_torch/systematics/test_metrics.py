"""Cached per-genotype Test-CPU metrics.

Counterpart of avida_tpu/systematics/test_metrics.py
(Systematics::GenomeTestMetrics, avida-core
source/systematics/GenomeTestMetrics.cc): sandbox metrics for a genotype
are computed once and memoized by genome content, so the reversion test
(cHardwareBase::Divide_TestFitnessMeasures cc:866), analyze-mode
recalculation and the checkpoint census (analyze/pipeline.py) do not
re-run gestations of genotypes already scored.  Uncached rows are
evaluated in ONE batched Test-CPU run (analyze/testcpu.evaluate_genomes).
"""

from __future__ import annotations

import numpy as np


class GenomeTestMetrics:
    """Host-side (genome bytes, seed) -> sandbox-record cache.

    A record is {"viable": bool, "fitness": float (0 when inviable),
    "gestation": int, "merit": float, "tasks": int64[R] task counts at
    divide}.  Evaluations run on `device` (the GPU unless named)."""

    def __init__(self, params, device=None):
        self.params = params
        self.device = device
        self._cache: dict[bytes, dict] = {}
        self.evaluations = 0    # genotypes actually run in the sandbox
        # the last call's rows, lanes evaluated, distinct genotypes among
        # them, and the batch's padded width and cycles
        self.last_stats: dict = {}

    def __len__(self):
        return len(self._cache)

    def get_records(self, genomes: np.ndarray, lens: np.ndarray,
                    seed: int = 0) -> list:
        """One cached record per genome row, content-keyed (the seed is
        part of the key: sandbox inputs derive from it).  Every uncached
        row gets its own sandbox lane, DUPLICATES INCLUDED (last write
        wins), as in the reference: the sandbox inputs are lane-indexed
        (testcpu._sandbox_inputs), so the lane a row lands on is part of
        its score."""
        from avida_tpu_torch.analyze.testcpu import evaluate_genomes

        keys = [(genomes[i, : int(lens[i])].tobytes(), int(seed))
                for i in range(genomes.shape[0])]
        miss = [i for i, k in enumerate(keys) if k not in self._cache]
        self.last_stats = {"rows": len(keys), "evaluated": len(miss),
                           "distinct": len({keys[i] for i in miss})}
        if miss:
            G = len(miss)
            sub = np.zeros((G, self.params.max_memory), np.int8)
            sub_lens = np.zeros(G, np.int32)
            for j, i in enumerate(miss):
                n = int(lens[i])
                sub[j, :n] = genomes[i, :n]
                sub_lens[j] = n
            res = evaluate_genomes(self.params, sub, sub_lens,
                                   seed=int(seed), device=self.device,
                                   stats=self.last_stats)
            self.evaluations += G
            for j, i in enumerate(miss):
                viable = bool(res.viable[j])
                self._cache[keys[i]] = {
                    "viable": viable,
                    "fitness": float(res.fitness[j]) if viable else 0.0,
                    "gestation": int(res.gestation_time[j]),
                    "merit": float(res.merit[j]),
                    "tasks": np.asarray(res.task_counts[j], np.int64),
                }
        return [self._cache[k] for k in keys]

    def get_fitness(self, genomes: np.ndarray, lens: np.ndarray,
                    seed: int = 0) -> np.ndarray:
        """f64[G] sandbox fitness for each genome row (0 = inviable)."""
        return np.asarray(
            [r["fitness"] for r in self.get_records(genomes, lens, seed)],
            np.float64)
