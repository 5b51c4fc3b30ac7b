"""Ops tools over a run's files, run as `python -m
avida_tpu_torch.tools.<name>`: ckpt_tool (checkpoint directories),
metrics_tool (the history rings and alert rules), fleet_tool (a fleet
spool: submit, list, cancel, requeue, churn traces), cache_tool (the
program cache: list, verify, prune), trace_tool (telemetry and spool
journals to a Chrome/Perfetto trace and back), perf_tool (the
attribution report and the bench-artifact diff) and analyze_tool
(offline analytics of a checkpoint directory).  Counterparts of the
reference's scripts/ of the same names.  All but analyze_tool run
without loading torch, beside a live or wedged run; analyze_tool runs
the analytics pipeline, on the card unless --device cpu is given."""
