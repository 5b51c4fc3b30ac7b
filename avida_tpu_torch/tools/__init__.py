"""Ops tools over a run's files, run as `python -m
avida_tpu_torch.tools.<name>`: ckpt_tool (checkpoint directories),
metrics_tool (the history rings and alert rules) and fleet_tool (a fleet
spool: submit, list, cancel, requeue, churn traces).  Counterparts of the
reference's scripts/ckpt_tool.py, scripts/metrics_tool.py and
scripts/fleet_tool.py.  None loads torch, so they run beside a live or
wedged run."""
