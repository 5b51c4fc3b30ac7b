"""Ops tools over a run's files, run as `python -m
avida_tpu_torch.tools.<name>`: ckpt_tool (checkpoint directories) and
metrics_tool (the history rings and alert rules).  Counterparts of the
reference's scripts/ckpt_tool.py and scripts/metrics_tool.py.  Neither
loads torch, so they run beside a live or wedged run."""
