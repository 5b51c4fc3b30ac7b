"""avida_tpu_torch: the Avida digital-evolution engine on PyTorch and CUDA.

The port of the JAX package `avida_tpu` (kept beside it as the reference)
to an NVIDIA H100.  Its main path is the packed-resident update engine:
per update a merit-proportional schedule, one launch of the hand-written
CUDA cycle interpreter (csrc/cycles.cu), the budget bank, the packed
birth flush and row-space statistics.  Configurations the kernel's gate
refuses, and TPU_USE_PALLAS=2, run their cycles on the micro-step engine
(ops/interpreter.micro_step, one lockstep cycle as tensor operations).
Entry points (`World`,
`python -m avida_tpu_torch`) run on `cuda` unless given device="cpu",
where every kernel is replaced by its plain PyTorch version.
"""
