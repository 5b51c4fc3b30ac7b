"""Run-service layer: the self-healing supervisor (supervisor.py) and its
restart pacing (backoff.py); the fleet orchestrator (fleet.py) that
drains a spool of job specs through many supervisors, and the streaming
serve layer (serve.py): the batchability classes its `--worlds`
coalescer keys on and the warm `--serve-worlds` class pool of
`--fleet --dynamic`.

Counterpart of avida_tpu/service/.  Host-only: nothing in this package
imports torch.  The supervisor and the orchestrator are the processes
that must stay alive while a run process crashes, hangs or corrupts
itself -- a wedged CUDA runtime in a child must not take the watchdog
down with it -- so they watch entirely from outside: child exit codes,
the metrics.prom heartbeat file and the checkpoint directory.

Child exit codes (set by avida_tpu_torch/__main__.py so the supervisor
can classify failures without parsing tracebacks):
"""

# sysexits-adjacent, chosen to be distinguishable from Python's generic
# exit 1 and from signal deaths (negative returncodes)
EXIT_AUDIT = 65      # StateInvariantError escaped World.run (EX_DATAERR)
EXIT_CKPT = 66       # no valid checkpoint generation on resume (EX_NOINPUT)
EXIT_SDC = 67        # StateDivergenceError: a scrub (shadow replay)
#                      caught silent data corruption (utils/integrity.py)

FAILURE_CLASSES = ("crash", "hang", "audit_violation", "corrupt_ckpt",
                   "sdc", "preempt")
