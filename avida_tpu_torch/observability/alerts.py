"""Declarative alert rules evaluated over the telemetry history rings.

The detection half of the observability plane: a small rule language
(`threshold` / `rate-over-window` / `staleness`, each with an optional
`for` duration) evaluated host-side over the `.hist.jsonl` rings that
observability/history.py appends beside every .prom snapshot.  The
evaluators are the processes that ALREADY poll heartbeats -- the run
supervisor (service/supervisor.py) and the fleet orchestrator
(service/fleet.py) -- plus the standalone `scripts/metrics_tool.py
watch` for spectators; no new processes, and nothing here imports torch.
A copy of avida_tpu/observability/alerts.py.

Rule shape (built-in defaults below; `alerts.json` in the data dir /
spool overrides or extends them, merged by name):

    {"name": "stall", "family": "avida_update",
     "kind": "rate", "op": "<=", "value": 0.0, "window_sec": 60,
     "for_sec": 0, "severity": "page", "action": null,
     "labels": null, "ring": "metrics", "enabled": true}

`ring` names the history ring the rule reads ("metrics" /
"multiworld" / "supervisor" / "fleet" -- the .hist.jsonl basename).
Rings are never merged across a rule: a serve batch's metrics ring
carries the batch-max update counter while its multiworld ring carries
per-tenant rows, and mixing the two would sawtooth any rate rule into
false pages every time a fresh tenant is admitted.  A rule with no
ring reads every ring the evaluator supplies (custom rules on families
that live in exactly one ring can omit it safely).  An evaluator that
does not own a rule's ring simply never fires it -- the fleet
orchestrator carries the run-level defaults harmlessly and vice
versa.

  kind=threshold   newest ring value of `family` compared `op value`;
                   labeled families collapse per sample to the WORST
                   row for the rule's direction (max for > rules, min
                   for < rules), so the alert fires when ANY series
                   trips
  kind=rate        per-second step-interpolated rate of `family` over
                   the trailing `window_sec`, compared `op value`; not
                   evaluable (never fires) until the ring spans the
                   window -- a run that just started is not stalled --
                   but a publisher that STOPPED appending still
                   evaluates (its counter definitionally went flat)
  kind=staleness   seconds since the family's newest ring sample,
                   compared > `value` (+ `for_sec`, which folds into
                   the threshold exactly -- age grows monotonically
                   between samples); an empty ring never fires (no
                   history is not evidence of staleness)

`for_sec` demands the condition hold continuously for that long before
the rule fires (evaluated statelessly by walking the ring backwards, so
a freshly-restarted evaluator reaches the same verdict).  A firing rule
resolves the moment its condition clears.

Alert state is journaled on EDGES as `{"record": "alert"}` lines in
`alerts.jsonl` beside the evaluator's journal, and exported as
`avida_alerts_firing{rule=...}` / `avida_alerts_fired_total{rule=...}`
families on the evaluator's existing .prom file.  Rules marked
`action: "degrade-hint"` additionally feed a breadcrumb into the fleet
failure tally / circuit breaker (admission pause at worst) -- this is a
detection plane, not a second supervisor: no rule ever kills a child.
"""

from __future__ import annotations

import json
import os
import time

from avida_tpu_torch.observability import history
from avida_tpu_torch.observability.records import append_record

ALERTS_FILE = "alerts.jsonl"
RULES_FILE = "alerts.json"

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

KINDS = ("threshold", "rate", "staleness")
SEVERITIES = ("info", "warn", "page")
ACTIONS = (None, "degrade-hint")


class Rule:
    """One declarative alert rule (see the module docstring for the
    JSON shape)."""

    __slots__ = ("name", "family", "kind", "op", "value", "window_sec",
                 "for_sec", "severity", "action", "labels", "ring",
                 "enabled")

    def __init__(self, name, family, kind, value, op=">", window_sec=60.0,
                 for_sec=0.0, severity="warn", action=None, labels=None,
                 ring=None, enabled=True):
        if kind not in KINDS:
            raise ValueError(f"alert rule {name!r}: unknown kind {kind!r} "
                             f"(one of {KINDS})")
        if op not in _OPS:
            raise ValueError(f"alert rule {name!r}: unknown op {op!r} "
                             f"(one of {sorted(_OPS)})")
        if severity not in SEVERITIES:
            raise ValueError(f"alert rule {name!r}: unknown severity "
                             f"{severity!r} (one of {SEVERITIES})")
        if action not in ACTIONS:
            raise ValueError(f"alert rule {name!r}: unknown action "
                             f"{action!r} (one of {ACTIONS})")
        self.name = str(name)
        self.family = str(family)
        self.kind = kind
        self.op = op
        try:
            # loud-but-survivable contract: a null/garbage numeric in
            # alerts.json must surface as ValueError, the one class the
            # supervisor/fleet guards catch when disabling alerts
            self.value = float(value)
            self.window_sec = float(window_sec)
            self.for_sec = float(for_sec)
        except (TypeError, ValueError) as e:
            raise ValueError(f"alert rule {name!r}: non-numeric "
                             f"value/window_sec/for_sec ({e})") from e
        self.severity = severity
        self.action = action
        self.labels = labels
        self.ring = None if ring is None else str(ring)
        self.enabled = bool(enabled)

    @property
    def agg(self):
        """How labeled rows collapse per sample: the WORST series for
        this rule's direction, so any-series-trips holds for both
        above- and below-threshold rules (history.series)."""
        return min if self.op in ("<", "<=") else max

    @classmethod
    def from_dict(cls, d) -> "Rule":
        if not isinstance(d, dict):
            raise ValueError(f"alert rule must be a JSON object: {d!r}")
        known = {"name", "family", "kind", "op", "value", "window_sec",
                 "for_sec", "severity", "action", "labels", "ring",
                 "enabled"}
        junk = set(d) - known
        if junk:
            raise ValueError(f"alert rule {d.get('name')!r}: unknown "
                             f"field(s) {sorted(junk)}")
        for req in ("name", "family", "kind", "value"):
            if req not in d:
                raise ValueError(f"alert rule needs {req!r}: {d!r}")
        return cls(**d)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


# ---------------------------------------------------------------------------
# built-in defaults: one rule per gauge the ROADMAP already cares about
# ---------------------------------------------------------------------------

def default_rules() -> list:
    return [
        # the heartbeat itself went quiet: the publisher wedged or died
        # (the supervisor's watchdog will act; this is the page)
        Rule("heartbeat_stale", "avida_heartbeat_timestamp_seconds",
             "staleness", 120.0, severity="page", ring="metrics"),
        # livelock: the update counter stopped advancing -- fires both
        # when publishes continue with a flat counter (wedged
        # scheduler) and when publishes stop entirely (hung chunk).
        # Pinned to the metrics ring: a serve batch's multiworld ring
        # carries PER-TENANT counters whose membership churns, which
        # a rate rule must never see
        Rule("stall", "avida_update", "rate", 0.0, op="<=",
             window_sec=60.0, severity="page", ring="metrics"),
        # world-axis batching occupancy collapsed: stragglers are
        # burning the batch's lockstep budget (PR-11 gauge)
        Rule("batch_efficiency_collapse",
             "avida_multiworld_batch_efficiency", "threshold", 0.2,
             op="<", for_sec=60.0, severity="warn", ring="multiworld"),
        # admissions cannot keep up: the queue has grown across the
        # whole window (fleet ring; PR-12 gauge)
        Rule("queue_growth", "avida_fleet_queue_depth", "rate", 0.0,
             op=">", window_sec=300.0, for_sec=300.0, severity="warn",
             ring="fleet"),
        # the integrity plane caught silent corruption (PR-14): every
        # mismatch means a rollback already happened -- page, and hint
        # the fleet that this device/class is suspect
        Rule("integrity_mismatch", "avida_integrity_mismatches_total",
             "threshold", 0.0, op=">", severity="page",
             action="degrade-hint", ring="metrics"),
        # the persistent AOT program cache is falling back to fresh
        # compiles (PR-13): cold-start windows are back
        Rule("compile_cache_errors", "avida_compile_cache_errors_total",
             "threshold", 0.0, op=">", severity="warn",
             ring="metrics"),
    ]


def load_rules(search_dir: str | None = None,
               rules_path: str | None = None) -> list:
    """Built-in defaults merged with an optional `alerts.json` override
    file (a JSON list of rule dicts; same-name entries replace the
    default -- set `"enabled": false` to drop one -- and new names
    extend the set).  A malformed file raises: a silently-ignored
    alert config is worse than a loud startup failure."""
    rules = {r.name: r for r in default_rules()}
    path = rules_path
    if path is None and search_dir:
        cand = os.path.join(search_dir, RULES_FILE)
        path = cand if os.path.exists(cand) else None
    if path:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, list):
            raise ValueError(f"{path}: alerts.json must be a JSON list "
                             f"of rule objects")
        for d in doc:
            r = Rule.from_dict(d)
            rules[r.name] = r
    return [r for r in rules.values() if r.enabled]


# ---------------------------------------------------------------------------
# stateless evaluation over a ring's samples
# ---------------------------------------------------------------------------

def _condition_at(rule: Rule, pts: list, t: float):
    """(holds, value) of the rule's raw condition as-of time `t`
    (staleness is handled by the caller -- it needs `now`, not a
    historical as-of)."""
    if rule.kind == "threshold":
        v = history.value_asof(pts, t)
        if v is None:
            return False, None
        return _OPS[rule.op](v, rule.value), v
    if rule.kind == "rate":
        r = history.rate_over(pts, t, rule.window_sec)
        if r is None:
            return False, None
        return _OPS[rule.op](r, rule.value), r
    raise AssertionError(rule.kind)


def evaluate_rule(rule: Rule, samples: list, now: float) -> dict:
    """{"firing": bool, "value": newest observed value/rate/age,
    "since": unix time the condition started holding (when firing)}.

    `for_sec` is evaluated statelessly: the condition must hold at
    `now` AND at every as-of point back through the trailing `for_sec`
    (sample times, plus the window edge), so a freshly-restarted
    evaluator reaches the same verdict as one that watched live."""
    pts = history.series(samples, rule.family, labels=rule.labels,
                         agg=rule.agg)
    if rule.kind == "staleness":
        if not pts:
            return {"firing": False, "value": None, "since": None}
        age = now - pts[-1][0]
        # for_sec folds into the threshold: with no fresh sample the
        # age grows monotonically, so "age > value held for for_sec"
        # is EXACTLY "age > value + for_sec" (any fresh sample resets
        # both clocks at once)
        effective = rule.value + rule.for_sec
        firing = age > effective
        return {"firing": firing, "value": round(age, 3),
                "since": pts[-1][0] + effective if firing else None}
    holds, value = _condition_at(rule, pts, now)
    if not holds:
        return {"firing": False, "value": value, "since": None}
    # walk the as-of points inside [now - for_sec, now]; the condition
    # must hold at each for the rule to fire.  With for_sec == 0 the
    # edge time IS the onset -- no backwards walk: this runs on the
    # supervision hot path every alert tick, and an O(ring) scan per
    # as-of point while a counter alert stays firing would make each
    # evaluation quadratic in the ring tail
    since = now
    if rule.for_sec > 0:
        cut = now - rule.for_sec
        asof = sorted({t for t, _ in pts if cut <= t <= now} | {cut})
        for t in asof:
            h, _ = _condition_at(rule, pts, t)
            if not h:
                return {"firing": False, "value": value, "since": None}
        since = cut
    return {"firing": True, "value": value, "since": since}


def samples_for(rule: Rule, samples) -> list:
    """The sample rows a rule may see.  `samples` is either a flat
    list (the rule sees everything -- unit-test and single-ring
    callers) or a {ring_name: samples} dict, in which case a ring-
    pinned rule reads ITS ring only and an unpinned rule reads the
    time-ordered concatenation.  Rings are never merged for a pinned
    rule: one family can mean different things in different rings
    (batch-max vs per-tenant avida_update on a serve child)."""
    if not isinstance(samples, dict):
        return samples
    if rule.ring is not None:
        return samples.get(rule.ring, [])
    merged = [s for rows in samples.values() for s in rows]
    merged.sort(key=lambda r: r.get("time", 0.0))
    return merged


def evaluate(rules: list, samples, now: float | None = None) -> dict:
    """{rule name: evaluate_rule result} for every enabled rule.
    `samples` is a flat row list or a {ring: rows} dict (see
    samples_for)."""
    now = time.time() if now is None else now
    return {r.name: evaluate_rule(r, samples_for(r, samples), now)
            for r in rules}


# ---------------------------------------------------------------------------
# the stateful edge-detector the poll loops embed
# ---------------------------------------------------------------------------

class AlertPlane:
    """Owns rule evaluation for one evaluator process: journals
    firing/resolved EDGES to `alerts.jsonl` (rotation-pair, durable --
    alert history is postmortem evidence), tallies fired counts, and
    renders the `avida_alerts_*` families for the evaluator's .prom
    file.  Never raises out of observe(): a broken ring or journal must
    not take down the supervision loop that hosts it."""

    def __init__(self, rules: list, journal_path: str | None = None,
                 max_bytes: int = 4 << 20, on_transition=None):
        self.rules = {r.name: r for r in rules}
        self.journal_path = journal_path
        self.max_bytes = int(max_bytes)
        self.firing: dict = {}          # name -> since (unix time)
        self.fired_total = {r.name: 0 for r in rules}
        self.last_values: dict = {}
        # hook(rule, state_str, result) on every edge -- the fleet's
        # degrade-hint breadcrumb rides this
        self.on_transition = on_transition

    def observe(self, samples, now: float | None = None) -> list:
        """Evaluate every rule against `samples` (a flat row list or a
        {ring: rows} dict -- see samples_for); journal and return the
        edge transitions ([(rule_name, "firing"|"resolved", result),
        ...])."""
        now = time.time() if now is None else now
        transitions = []
        try:
            results = evaluate(list(self.rules.values()), samples, now)
        except Exception:
            return transitions
        for name, res in results.items():
            self.last_values[name] = res.get("value")
            was = name in self.firing
            if res["firing"] and not was:
                self.firing[name] = res.get("since") or now
                self.fired_total[name] += 1
                transitions.append((name, "firing", res))
            elif not res["firing"] and was:
                del self.firing[name]
                transitions.append((name, "resolved", res))
        for name, state, res in transitions:
            self._journal(name, state, res, now)
            if self.on_transition is not None:
                try:
                    self.on_transition(self.rules[name], state, res)
                except Exception:
                    pass
        return transitions

    def _journal(self, name: str, state: str, res: dict, now: float):
        if not self.journal_path:
            return
        rule = self.rules[name]
        rec = {"record": "alert", "rule": name, "state": state,
               "time": round(now, 3), "severity": rule.severity,
               "family": rule.family, "kind": rule.kind}
        if res.get("value") is not None:
            rec["value"] = res["value"]
        if state == "firing" and res.get("since") is not None:
            rec["since"] = round(res["since"], 3)
        if rule.action:
            rec["action"] = rule.action
        try:
            append_record(self.journal_path, rec,
                          max_bytes=self.max_bytes, durable=True)
        except OSError:
            pass

    def families(self) -> list:
        """The exporter.render_families tuples for the evaluator's
        .prom file: per-rule firing gauges (0/1 for every rule, so a
        scraper sees resolution, not sample disappearance) and the
        cumulative fired counter."""
        if not self.rules:
            return []
        return [
            ("avida_alerts_firing", "gauge",
             "1 while the named alert rule's condition holds",
             {f'rule="{n}"': int(n in self.firing)
              for n in sorted(self.rules)}),
            ("avida_alerts_fired_total", "counter",
             "alert rule firing edges since this evaluator started",
             {f'rule="{n}"': self.fired_total[n]
              for n in sorted(self.rules)}),
        ]


def read_alert_records(journal_path: str) -> list:
    """All {"record": "alert"} lines across the rotation pair, oldest
    first (the trace_tool/metrics_tool reader)."""
    out = []
    for p in (journal_path + ".1", journal_path):
        try:
            f = open(p)
        except OSError:
            continue
        with f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("record") == "alert":
                    out.append(rec)
    return out


def firing_from_metrics(metrics: dict) -> dict:
    """{rule: fired_total} for FIRING rules plus the full rule set,
    parsed from an evaluator's .prom dict -- the `--status` column's
    source.  Returns {"firing": {rule: 1}, "fired": {rule: n},
    "rules": [names]}."""
    firing, fired, names = {}, {}, set()
    for k, v in metrics.items():
        if k.startswith('avida_alerts_firing{rule="'):
            name = k.split('rule="', 1)[1].rstrip('"}')
            names.add(name)
            if v:
                firing[name] = int(v)
        elif k.startswith('avida_alerts_fired_total{rule="'):
            name = k.split('rule="', 1)[1].rstrip('"}')
            names.add(name)
            if v:
                fired[name] = int(v)
    return {"firing": firing, "fired": fired, "rules": sorted(names)}


def format_alert_status(metrics: dict) -> str | None:
    """One-line digest of an evaluator's alert families for --status
    (None when the .prom carries no alert plane)."""
    d = firing_from_metrics(metrics)
    if not d["rules"]:
        return None
    if not d["firing"]:
        total = sum(d["fired"].values())
        suffix = f", {total} fired so far" if total else ""
        return f"alerts      none firing ({len(d['rules'])} rules{suffix})"
    parts = [f"{n} FIRING ({d['fired'].get(n, 0)}x)"
             for n in sorted(d["firing"])]
    return "alerts      " + ", ".join(parts)
