"""Runtime telemetry: phase timers, device counters, structured run logs.

Counterpart of avida_tpu/observability/:

  timeline.py -- `Timeline`: fenced phase wall clocks + torch.profiler
                 trace capture
  counters.py -- device-side counter reductions: births/deaths, task
                 triggers, per-block budget-tail utilization, the
                 dispatch-mix accumulator of the micro-step engine
  staged.py   -- `StagedUpdate`: the update's phase functions run one by
                 one, fenced (bit-identical trajectory to update_step)
  runlog.py   -- `TelemetryRecorder`/`TelemetryWriter`: telemetry.jsonl
  harness.py  -- the phase and end-to-end measurers
  tracer.py   -- `FlightRecorder`: the host drain of the device-side
                 event ring (TPU_TRACE=1) into {"record": "trace"} lines
  events.py   -- its event codes (no imports: trace_tool reads them)
  exporter.py -- `MetricsExporter`: the atomic metrics.prom heartbeat +
                 `python -m avida_tpu_torch --status DIR`
  history.py  -- the .hist.jsonl time-series rings beside each .prom
  alerts.py   -- the alert rules over those rings
  profiler.py -- `ChunkProfiler`: per-chunk attribution (TPU_PROFILE)
  perfread.py -- the torch-free readers perf_tool needs: metrics.prom,
                 perf.jsonl, bench artifacts and their provenance

Everything is opt-in (TPU_TELEMETRY=1 / `--telemetry`, TPU_TRACE,
TPU_METRICS, TPU_PROFILE); with all of them off nothing here runs and no
file is written.  Names resolve lazily, so `--status` reaches exporter.py
without importing torch.
"""

_EXPORTS = {
    "budget_block": "counters", "budget_tail": "counters",
    "dispatch_init": "counters", "update_counters": "counters",
    "MetricsExporter": "exporter",
    "profile_phases": "harness",
    "TelemetryRecorder": "runlog", "TelemetryWriter": "runlog",
    "StagedUpdate": "staged",
    "Timeline": "timeline",
    "EVENT_CODES": "events", "FlightRecorder": "tracer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(
        importlib.import_module(f"avida_tpu_torch.observability.{mod}"), name)
