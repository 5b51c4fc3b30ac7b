"""The flight recorder's event codes (observability/tracer.py has the
catalogue's meaning of cell and payload).  Imports nothing: the
tools that read a run's telemetry.jsonl (tools/trace_tool.py) name the
codes without loading torch."""

EV_BIRTH = 1
EV_DEATH = 2
EV_TASK_FIRST = 3
EV_SCHED_STALL = 4
EV_ANOM_MERIT = 5
EV_ANOM_HEAD = 6
EV_REVERT = 7
EV_STERILIZE = 8

EVENT_CODES = {
    EV_BIRTH: "birth",
    EV_DEATH: "death",
    EV_TASK_FIRST: "task_first",
    EV_SCHED_STALL: "sched_stall",
    EV_ANOM_MERIT: "anom_merit",
    EV_ANOM_HEAD: "anom_head",
    EV_REVERT: "revert",
    EV_STERILIZE: "sterilize",
}

# highest code the DEVICE ring can contain: EV_REVERT/EV_STERILIZE are
# host-side merges (FlightRecorder.record_host) that never enter tr_code
# -- the auditor bounds live ring entries by this, not max(EVENT_CODES)
DEVICE_MAX_CODE = EV_ANOM_HEAD
