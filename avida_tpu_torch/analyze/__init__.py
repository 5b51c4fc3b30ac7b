"""Analyze package: the batched Test CPU (testcpu.py), the per-cycle
trace (trace.py), the analyze VM (analyzer.py) and the checkpoint
analytics pipeline (pipeline.py).  Counterpart of avida_tpu/analyze/.

Lazy re-exports, as the reference's: importing analyze.pipeline for its
host-only pieces does not import the Test CPU."""


def __getattr__(name):
    if name in ("evaluate_genomes", "TestResult"):
        from avida_tpu_torch.analyze import testcpu
        return getattr(testcpu, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
