"""Runlog <-> Chrome/Perfetto trace converter (flight recorder + Timeline).
Counterpart of the reference's scripts/trace_tool.py, over the port's
telemetry.jsonl and spool journals; it loads no torch.

Usage:
    python -m avida_tpu_torch.tools.trace_tool to-chrome telemetry.jsonl \
        [-o trace.json]
    python -m avida_tpu_torch.tools.trace_tool from-chrome trace.json \
        [-o trace.jsonl]
    python -m avida_tpu_torch.tools.trace_tool summary telemetry.jsonl
    python -m avida_tpu_torch.tools.trace_tool fleet SPOOL [-o trace.json]

`fleet` merges a whole spool's journals -- fleet.jsonl, every job's
supervisor.jsonl, the alert journals (alerts.jsonl at both layers,
observability/alerts.py) and each job's metrics history ring
(observability/history.py) -- into ONE wall-clock-correlated Perfetto
trace: one process track per job (plus one for the orchestrator),
spans for admit->terminal and for every supervisor boot, spans for
firing->resolved alerts, a per-job `avida_update` counter track with
chunk-boundary spans from the history ring, and instant events for
injected faults, watchdog kills, rollbacks, SDC exits and breaker
trips -- so a churn drill or an incident reads as a single correlated
timeline instead of five journals diffed by hand.  Jobs armed with
TPU_PROFILE=1 additionally get a `perf` row: each chunk interval is
split proportionally into the avida_perf_phase_ms{phase=...} staged
phases the history ring sampled (observability/profiler.py), so the
attribution plane reads on the same wall-clock timeline.

`to-chrome` renders a run's telemetry.jsonl -- the per-update phase
wall-time records ({"record": "update"}, observability/timeline.py) and the
flight-recorder event records ({"record": "trace"}, observability/
tracer.py) -- as a Chrome trace-event JSON that chrome://tracing and
ui.perfetto.dev open directly:

  - each update becomes a frame on a synthetic timeline whose clock is
    the SUM of recorded update wall times (host gaps between updates are
    not update work and are excluded, matching the runlog's own wall_ms
    semantics); phase brackets (schedule / pack / kernel / birth_flush /
    events_io ...) are complete events ("ph": "X") on per-phase rows;
  - flight-recorder events (births, deaths, first task triggers,
    scheduler stalls, anomalies) are instant events ("ph": "i") at their
    update's frame start, one Chrome thread row per event code, with
    cell/payload in args.

Runs without phase records (TPU_TRACE=1 but telemetry off) still
convert: updates with only trace events get a nominal frame length so
the event timeline stays ordered and zoomable.

`from-chrome` inverts the instant events back into {"record": "trace"}
JSONL (grouped per update, sorted) -- the same shape the FlightRecorder
drain appends, including the ring-overflow "dropped" counter (carried
through the trace as "trace_dropped" markers) -- so a trace.json edited
or filtered in the Perfetto UI can be re-ingested by runlog tooling.
Phase rows do not round-trip (the runlog's per-update phase dict is the
source of truth for those).

`summary` prints per-code event totals and the per-update event rate,
the quick "what happened in this run" view.  It also understands the
analytics pipeline's `{"record": "analytics"}` lines
(analyze/pipeline.py -- point it at DATA_DIR/analysis/analytics.jsonl):
census cadence, genotypes evaluated, knockout sweeps and the last
census digest ride the same summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


from avida_tpu_torch.observability import history
from avida_tpu_torch.observability.alerts import read_alert_records
from avida_tpu_torch.observability.events import EVENT_CODES
from avida_tpu_torch.observability.records import read_records

_CODE_BY_NAME = {name: code for code, name in EVENT_CODES.items()}

# Chrome trace tid layout: update frames on tid 1, one row per event
# code from 10, one row per phase name from 100
_PHASE_TID = 1
_EVENT_TID_BASE = 10
_PHASE_ROW_BASE = 100

# nominal frame for updates that carry events but no phase record
# (telemetry off): 1 ms keeps the timeline ordered and zoomable
_NOMINAL_MS = 1.0


def read_runlog(path: str, analytics: list | None = None):
    """(updates, traces, meta, drops): per-update phase records,
    per-update flight-recorder event lists, the meta record (or {}),
    and per-update ring-overflow drop counts.  When `analytics` is a
    list, {"record": "analytics"} census records (analyze/pipeline.py)
    are appended to it in file order."""
    updates, traces, meta = {}, {}, {}
    drops = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                    # torn tail from a crash
            kind = rec.get("record")
            if kind == "update":
                updates[int(rec["update"])] = rec
            elif kind == "trace":
                u = int(rec["update"])
                traces.setdefault(u, []).extend(rec.get("events", []))
                if rec.get("dropped"):
                    drops[u] = drops.get(u, 0) + int(rec["dropped"])
            elif kind == "meta":
                meta = rec
            elif kind == "analytics" and analytics is not None:
                analytics.append(rec)
    return updates, traces, meta, drops


def to_chrome(path: str) -> dict:
    """Chrome trace-event dict for a telemetry.jsonl runlog."""
    updates, traces, meta, drops = read_runlog(path)
    events = []
    pid = 1
    events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": "avida-tpu run"}})
    events.append({"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": _PHASE_TID, "args": {"name": "updates"}})
    tids = {}
    for code in sorted(EVENT_CODES):
        tid = _EVENT_TID_BASE + code
        tids[code] = tid
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"trace:{EVENT_CODES[code]}"}})
    phase_tids = {}
    for rec in updates.values():
        for phase in (rec.get("phases") or {}):
            if phase not in phase_tids:
                tid = _PHASE_ROW_BASE + len(phase_tids)
                phase_tids[phase] = tid
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tid,
                               "args": {"name": f"phase:{phase}"}})

    cursor_us = 0.0
    for u in sorted(set(updates) | set(traces)):
        rec = updates.get(u)
        wall_ms = float(rec.get("wall_ms", _NOMINAL_MS)) if rec \
            else _NOMINAL_MS
        start_us = cursor_us
        events.append({
            "name": f"update {u}", "ph": "X", "pid": pid, "tid": _PHASE_TID,
            "ts": start_us, "dur": wall_ms * 1e3,
            "args": (rec or {}).get("counters", {}),
        })
        t = start_us
        for phase, ms in ((rec or {}).get("phases") or {}).items():
            events.append({"name": phase, "ph": "X", "pid": pid,
                           "tid": phase_tids[phase], "ts": t, "dur": ms * 1e3,
                           "args": {"update": u}})
            t += ms * 1e3
        if u in drops:
            events.append({"name": "trace_dropped", "ph": "i", "pid": pid,
                           "tid": _PHASE_TID, "ts": start_us, "s": "t",
                           "args": {"update": u, "dropped": drops[u]}})
        for cell, code, payload in traces.get(u, ()):
            events.append({
                "name": EVENT_CODES.get(code, f"code{code}"), "ph": "i",
                "pid": pid, "tid": tids.get(code, _EVENT_TID_BASE),
                "ts": start_us, "s": "t",
                "args": {"update": u, "cell": cell, "payload": payload},
            })
        cursor_us += wall_ms * 1e3
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = {k: meta[k] for k in
                            ("seed", "world", "platform", "interpret_path")
                            if k in meta}
    return out


def from_chrome(path: str):
    """Invert a to-chrome trace.json's instant events back into
    {"record": "trace"} JSONL records (list of dicts, update-sorted)."""
    with open(path) as f:
        doc = json.load(f)
    per_update = {}
    drops = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "i":
            continue
        args = ev.get("args") or {}
        if "update" not in args:
            continue
        u = int(args["update"])
        if ev.get("name") == "trace_dropped":
            drops[u] = drops.get(u, 0) + int(args.get("dropped", 0))
            continue
        code = _CODE_BY_NAME.get(ev.get("name"))
        if code is None:
            continue
        per_update.setdefault(u, []).append(
            [int(args.get("cell", -1)), code, int(args.get("payload", 0))])
    recs = []
    for u in sorted(set(per_update) | set(drops)):
        rec = {"record": "trace", "update": u,
               "events": per_update.get(u, [])}
        if u in drops:
            rec["dropped"] = drops[u]
        recs.append(rec)
    return recs


def summary(path: str) -> str:
    analytics = []
    updates, traces, _, drops = read_runlog(path, analytics=analytics)
    totals = {}
    for evs in traces.values():
        for _, code, _ in evs:
            name = EVENT_CODES.get(code, f"code{code}")
            totals[name] = totals.get(name, 0) + 1
    n_ev = sum(totals.values())
    span = (max(traces) - min(traces) + 1) if traces else 0
    lines = [f"updates with phase records: {len(updates)}",
             f"updates with trace events:  {len(traces)} (span {span})",
             f"events total:               {n_ev}"]
    if drops:
        lines.append(f"events dropped (overflow):  {sum(drops.values())}")
    for name in sorted(totals, key=totals.get, reverse=True):
        lines.append(f"  {name:<12} {totals[name]}")
    if analytics:
        last = analytics[-1]
        dom = last.get("dominant") or {}
        held = int(last.get("tasks_held_mask", 0))
        lines += [
            f"analytics records:          {len(analytics)} "
            f"(censuses @ updates "
            f"{analytics[0].get('update')}..{last.get('update')})",
            f"  genotypes evaluated       "
            f"{int(last.get('evaluated_total', 0))} total, "
            f"{int(last.get('knockout_sweeps_total', 0))} knockout "
            f"sweep(s)",
            f"  last census               "
            f"{int(last.get('genotypes', 0))} genotypes, dominant gid "
            f"{dom.get('gid', -1)} depth {dom.get('depth', 0)}, tasks "
            f"{held:#x} ({bin(held).count('1')} held)",
        ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# fleet mode: one correlated timeline for a whole spool
# ---------------------------------------------------------------------------

_FLEET_PID = 1
_JOB_PID_BASE = 10

# instant-worthy supervisor events and the fleet events that mark a
# job's lifecycle edges
_SUP_INSTANTS = ("watchdog_kill", "rollback", "sdc_rollback",
                 "sdc_digest_quarantine", "pallas_fallback",
                 "anomaly_detected", "backoff", "budget_reset",
                 "checkpoint_fallback_observed", "giving_up")
_TERMINAL_EVENTS = ("done", "failed", "cancelled", "requeued",
                    "quarantined")


def _job_names(spool: str, fleet_recs: list) -> list:
    names = {rec["job"] for rec in fleet_recs
             if isinstance(rec.get("job"), str) and rec["job"]}
    for entry in sorted(os.listdir(spool)) if os.path.isdir(spool) else ():
        if os.path.isdir(os.path.join(spool, entry, "data")):
            names.add(entry)
    return sorted(names)


def _span(name, pid, tid, t0, t1, base, **args_):
    return {"name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": (t0 - base) * 1e6,
            "dur": max((t1 - t0) * 1e6, 1.0), "args": args_}


def _instant(name, pid, tid, t, base, **args_):
    return {"name": name, "ph": "i", "pid": pid, "tid": tid,
            "ts": (t - base) * 1e6, "s": "t", "args": args_}


def _alert_spans(journal_path, pid, tid, base, t_end, events):
    """firing->resolved alert spans (+ instants on the edges) from an
    alerts.jsonl rotation pair; an unresolved alert spans to t_end."""
    open_since = {}
    for rec in read_alert_records(journal_path):
        rule, t = rec.get("rule"), float(rec.get("time", 0.0))
        if rec.get("state") == "firing":
            open_since[rule] = (t, rec)
        elif rec.get("state") == "resolved" and rule in open_since:
            t0, fire_rec = open_since.pop(rule)
            events.append(_span(f"alert:{rule}", pid, tid, t0, t, base,
                                severity=fire_rec.get("severity"),
                                value=fire_rec.get("value")))
    for rule, (t0, fire_rec) in open_since.items():
        events.append(_span(f"alert:{rule} (unresolved)", pid, tid, t0,
                            max(t_end, t0), base,
                            severity=fire_rec.get("severity"),
                            value=fire_rec.get("value")))


def fleet_trace(spool: str) -> dict:
    """The merged Chrome/Perfetto trace dict for one spool."""
    fleet_recs = [r for r in
                  read_records(os.path.join(spool, "fleet.jsonl"))
                  if r.get("record") == "fleet"]
    names = _job_names(spool, fleet_recs)
    # every journal is read up front so base/t_end span ALL layers --
    # open-ended spans ("live" boots, unresolved alerts) must end at
    # the global horizon, not at whichever journal happened to be read
    # before them
    sup_by_job = {name: [r for r in read_records(os.path.join(
        spool, name, "data", "supervisor.jsonl"))
        if r.get("record") == "supervisor"] for name in names}
    ring_by_job = {name: history.read_samples(history.hist_path(
        os.path.join(spool, name, "data", "metrics.prom")))
        for name in names}
    times = [float(r.get("time", 0.0)) for r in fleet_recs
             if r.get("time")]
    for recs in sup_by_job.values():
        times += [float(r.get("time", 0.0)) for r in recs
                  if r.get("time")]
    for samples in ring_by_job.values():
        times += [float(r.get("time", 0.0)) for r in samples]
    for p in ([os.path.join(spool, "alerts.jsonl")]
              + [os.path.join(spool, n, "data", "alerts.jsonl")
                 for n in names]):
        times += [float(r.get("time", 0.0))
                  for r in read_alert_records(p) if r.get("time")]
    base = min(times) if times else 0.0
    t_end = max(times) if times else 0.0

    events = [{"name": "process_name", "ph": "M", "pid": _FLEET_PID,
               "tid": 0, "args": {"name": f"fleet {spool}"}},
              {"name": "thread_name", "ph": "M", "pid": _FLEET_PID,
               "tid": 1, "args": {"name": "orchestrator"}},
              {"name": "thread_name", "ph": "M", "pid": _FLEET_PID,
               "tid": 2, "args": {"name": "alerts"}}]
    job_pid = {n: _JOB_PID_BASE + i for i, n in enumerate(names)}

    # ---- fleet orchestrator track ----
    admit_t, terminal_t = {}, {}
    for rec in fleet_recs:
        ev, t = rec.get("event"), float(rec.get("time", 0.0))
        job = rec.get("job")
        if ev == "admit" and job:
            admit_t.setdefault(job, t)
        if ev in _TERMINAL_EVENTS and job:
            terminal_t[job] = (t, ev)
        if ev in ("fleet_start", "fleet_stop", "breaker_open",
                  "breaker_close", "xla_fallback", "alert", "drain",
                  "coalesced", "batch_fallback", "degrade_hint",
                  "serve_class", "serve_reattach"):
            args_ = {k: v for k, v in rec.items()
                     if k not in ("record", "time")}
            events.append(_instant(ev, _FLEET_PID, 1, t, base, **args_))
    _alert_spans(os.path.join(spool, "alerts.jsonl"), _FLEET_PID, 2,
                 base, t_end, events)

    # ---- one process per job ----
    for name in names:
        pid = job_pid[name]
        data = os.path.join(spool, name, "data")
        events += [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"job {name}"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
             "args": {"name": "lifecycle"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 2,
             "args": {"name": "boots"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 3,
             "args": {"name": "alerts"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 4,
             "args": {"name": "chunks"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 5,
             "args": {"name": "perf"}},
        ]
        # admit -> terminal lifecycle span from the fleet journal
        if name in admit_t:
            t1, how = terminal_t.get(name, (t_end, "live"))
            events.append(_span(f"{name} [{how}]", pid, 1,
                                admit_t[name], max(t1, admit_t[name]),
                                base, outcome=how))
        # supervisor boots + instants
        launch = {}
        for rec in sup_by_job[name]:
            ev = rec.get("event")
            t = float(rec.get("time", 0.0))
            boot = int(rec.get("boot", 0))
            if ev == "launch":
                launch[boot] = (t, rec.get("fault") or "")
                if rec.get("fault"):
                    events.append(_instant(
                        f"fault:{rec['fault']}", pid, 2, t, base,
                        boot=boot))
            elif ev == "exit" and boot in launch:
                t0, fault = launch.pop(boot)
                events.append(_span(
                    f"boot {boot} [{rec.get('class')}]", pid, 2, t0, t,
                    base, exit_class=rec.get("class"),
                    code=rec.get("code"), update=rec.get("update"),
                    fault=fault))
                if rec.get("class") == "sdc":
                    events.append(_instant("sdc", pid, 2, t, base,
                                           code=rec.get("code")))
            elif ev in _SUP_INSTANTS:
                args_ = {k: v for k, v in rec.items()
                         if k not in ("record", "time", "stderr_tail")}
                events.append(_instant(ev, pid, 2, t, base, **args_))
        for boot, (t0, fault) in launch.items():
            events.append(_span(f"boot {boot} [live]", pid, 2, t0,
                                max(t_end, t0), base, fault=fault))
        # per-job alert spans
        _alert_spans(os.path.join(data, "alerts.jsonl"), pid, 3, base,
                     t_end, events)
        # update-counter track + chunk spans from the history ring
        samples = ring_by_job[name]
        prev = None
        for rec in samples:
            t = float(rec.get("time", 0.0))
            u = rec.get("update")
            if u is None:
                continue
            events.append({"name": "avida_update", "ph": "C",
                           "pid": pid, "tid": 4,
                           "ts": (t - base) * 1e6,
                           "args": {"update": u}})
            if prev is not None and t > prev[0] and u > prev[1]:
                events.append(_span(f"chunk ->u{u}", pid, 4, prev[0], t,
                                    base, updates=u - prev[1]))
                # attribution-plane sub-spans (TPU_PROFILE=1 runs): the
                # chunk interval split proportionally by the staged
                # phase breakdown the ring sampled at this boundary
                phases = {k.split('phase="', 1)[1].rstrip('"}'): float(v)
                          for k, v in rec.items()
                          if isinstance(v, (int, float))
                          and str(k).startswith('avida_perf_phase_ms{')}
                total = sum(phases.values())
                if total > 0:
                    pt = prev[0]
                    for ph, ms in sorted(phases.items(),
                                         key=lambda kv: -kv[1]):
                        pt1 = pt + (t - prev[0]) * (ms / total)
                        events.append(_span(f"perf:{ph}", pid, 5, pt,
                                            pt1, base,
                                            probe_ms=round(ms, 3)))
                        pt = pt1
            prev = (t, u)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spool": spool, "jobs": names,
                          "base_unix_time": base}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["to-chrome", "from-chrome", "summary",
                                    "fleet"])
    p.add_argument("path")
    p.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)

    if args.mode == "summary":
        print(summary(args.path))
        return 0
    if args.mode == "fleet":
        doc = fleet_trace(args.path)
        out = args.out or os.path.join(args.path, "fleet.trace.json")
        with open(out, "w") as f:
            json.dump(doc, f)
        print(f"{out}: {len(doc['traceEvents'])} trace events across "
              f"{len(doc['otherData']['jobs'])} job(s) "
              f"(open in chrome://tracing or ui.perfetto.dev)")
        return 0
    if args.mode == "to-chrome":
        doc = to_chrome(args.path)
        out = args.out or os.path.splitext(args.path)[0] + ".trace.json"
        with open(out, "w") as f:
            json.dump(doc, f)
        print(f"{out}: {len(doc['traceEvents'])} trace events "
              f"(open in chrome://tracing or ui.perfetto.dev)")
        return 0
    recs = from_chrome(args.path)
    out = args.out or os.path.splitext(args.path)[0] + ".trace.jsonl"
    with open(out, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    print(f"{out}: {len(recs)} trace records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
