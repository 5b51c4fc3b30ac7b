"""Deterministic churn traces: streaming fleet traffic you can replay.

Counterpart of avida_tpu/utils/churntrace.py (same grammar, same
generator: a seed gives the reference's trace byte for byte).  A fleet's
behavior under CHURN -- arrivals, cancels, completions interleaving
against live batches -- can only be trusted (or benched honestly) when
it is driven with the same traffic twice.  This module extends the
fault-injection discipline (utils/faultinject.py: seeded, text-spec'd,
reproducible byte-for-byte) from single-process faults to fleet-level
traffic.

Trace grammar (one event per line; the TPU_FAULT `kind:args@trigger`
shape with a time trigger):

    event  := kind [":" args] "@" "t=" FLOAT
    kind   := "submit" | "cancel"
    args   := KEY "=" VALUE ("," KEY "=" VALUE)*

`submit` takes `job=NAME` plus the per-tenant knobs the replayer turns
into a spec: `seed=N`, `u=MAX_UPDATES`, optional `class=K` (an index
into the replayer's static-config variants -- distinct batchability
classes), optional `tenant=T` (the quota label).  `cancel` takes
`job=NAME`.  `complete` events are deliberately NOT in the grammar:
completion is emergent (a tenant finishes when its own `u` budget is
reached), so a trace stays valid across engine speedups.

`generate` draws a whole trace from one integer seed (`fleet_tool
gen-trace`); `parse_trace`/`replay` drive a live spool from one, so two
runs can replay the same committed trace file.
"""

from __future__ import annotations

import os
import random
import time

KINDS = ("submit", "cancel")


class ChurnEvent:
    """One parsed trace line."""

    def __init__(self, t: float, kind: str, args: dict, text: str):
        self.t = float(t)
        self.kind = kind
        self.args = args
        self.text = text

    @property
    def job(self) -> str:
        return self.args.get("job", "")

    def __repr__(self):
        return f"ChurnEvent({self.text!r})"


def parse_event(text: str) -> ChurnEvent:
    part = text.strip()
    if "@" not in part:
        raise ValueError(f"churn event {text!r}: missing @t=SECONDS "
                         f"trigger")
    part, trig = part.rsplit("@", 1)
    name, eq, val = trig.partition("=")
    if not eq or name.strip() != "t":
        raise ValueError(f"churn event {text!r}: trigger must be t=SECONDS")
    t = float(val)
    kind, _, argstr = part.partition(":")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(f"unknown churn kind {kind!r} in {text!r} "
                         f"(known: {', '.join(KINDS)})")
    args = {}
    for tok in argstr.split(","):
        tok = tok.strip()
        if not tok:
            continue
        k, eq, v = tok.partition("=")
        if not eq:
            raise ValueError(f"churn event {text!r}: bare argument "
                             f"{tok!r} (every arg is KEY=VALUE)")
        args[k.strip()] = v.strip()
    if not args.get("job"):
        raise ValueError(f"churn event {text!r}: needs job=NAME")
    if kind == "submit":
        for req in ("seed", "u"):
            int(args.get(req, ""))      # required, integer -- raises
    return ChurnEvent(t, kind, args, text.strip())


def parse_trace(path_or_lines) -> list:
    """Parse a trace file (or an iterable of lines) into time-sorted
    ChurnEvents.  `#` comments and blank lines are skipped."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    events = []
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if line:
            events.append(parse_event(line))
    if not events:
        raise ValueError("empty churn trace")
    events.sort(key=lambda e: (e.t, e.kind != "submit", e.job))
    return events


def generate(seed: int, jobs: int = 12, classes: int = 1,
             cancel_frac: float = 0.2, span: float = 30.0,
             updates: int = 40, tenants: int = 1) -> list:
    """Draw a deterministic arrival/cancel trace: `jobs` submissions
    uniform over [0, span), round-robin across `classes` static
    variants and `tenants` quota labels, with `cancel_frac` of the
    tenants cancelled somewhere after their arrival.  Same seed, same
    trace -- byte for byte (the faultinject seeding discipline)."""
    rng = random.Random(int(seed))
    lines = []
    arrivals = sorted(round(rng.uniform(0.0, float(span)), 2)
                      for _ in range(int(jobs)))
    cancels = rng.sample(range(int(jobs)),
                         int(round(int(jobs) * float(cancel_frac))))
    for i, t in enumerate(arrivals):
        args = [f"job=t{i:03d}", f"seed={rng.randrange(1, 10_000)}",
                f"u={int(updates)}"]
        if classes > 1:
            args.append(f"class={i % int(classes)}")
        if tenants > 1:
            args.append(f"tenant=org{i % int(tenants)}")
        lines.append(ChurnEvent(t, "submit",
                                dict(a.split("=", 1) for a in args),
                                f"submit:{','.join(args)}@t={t}"))
        if i in cancels:
            ct = round(t + rng.uniform(1.0, float(span)), 2)
            lines.append(ChurnEvent(ct, "cancel", {"job": f"t{i:03d}"},
                                    f"cancel:job=t{i:03d}@t={ct}"))
    lines.sort(key=lambda e: (e.t, e.kind != "submit", e.job))
    return lines


def format_trace(events, seed=None, note: str = "") -> str:
    head = ["# churn trace (utils/churntrace.py grammar: "
            "kind:args@t=SECONDS)"]
    if seed is not None:
        head.append(f"# generated with --seed {seed}")
    if note:
        head.append(f"# {note}")
    return "\n".join(head + [e.text for e in events]) + "\n"


def replay(spool: str, events, argv_for, batch: bool = True,
           speed: float = 1.0, clock=time.time, sleep=time.sleep,
           on_event=None) -> dict:
    """Drive a live spool with a parsed trace: submits via
    tools/fleet_tool.submit, cancels via the operator marker files the
    orchestrator consumes on its next poll.  `argv_for(event)` maps a
    submit event to the child argv (the caller owns the static-config
    variants `class=K` indexes).  Times are scaled by `speed`
    (0 = as fast as possible).  Returns {job: wall-clock submit time}
    -- the queue-wait measurement baseline."""
    from avida_tpu_torch.tools import fleet_tool
    t0 = clock()
    submitted = {}
    for ev in events:
        due = t0 + ev.t * speed
        while clock() < due:
            sleep(min(due - clock(), 0.2))
        if ev.kind == "submit":
            spec_kw = {}
            if ev.args.get("tenant"):
                spec_kw["tenant"] = ev.args["tenant"]
            fleet_tool.submit(spool, ev.job, argv_for(ev), batch=batch,
                              **spec_kw)
            submitted[ev.job] = clock()
        elif ev.kind == "cancel":
            try:
                with open(os.path.join(spool, ev.job + ".cancel"),
                          "w"):
                    pass
            except OSError:
                pass
        if on_event is not None:
            on_event(ev)
    return submitted
