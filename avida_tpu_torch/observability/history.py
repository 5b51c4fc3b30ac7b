"""On-disk time-series rings beside every .prom snapshot.

The metrics plane (observability/exporter.py and the supervisor/fleet
counter files) rewrites point-in-time `.prom` snapshots every heartbeat
-- an operator can see the CURRENT update rate, queue depth or SDC
count, but never a rate, a trend, or "when did this start?".  This
module keeps the recent past: each heartbeat publish additionally
appends ONE compact sample row -- wall time, update counter, and the
numeric value of every family the publish just rendered -- to a bounded
JSONL ring beside the snapshot:

    metrics.prom      ->  metrics.hist.jsonl
    multiworld.prom   ->  multiworld.hist.jsonl
    supervisor.prom   ->  supervisor.hist.jsonl
    fleet.prom        ->  fleet.hist.jsonl

Sample rows are `{"record": "sample", "time": T, "update": U, "v":
{family-or-family{labels}: value, ...}}`.  The ring reuses
records.append_record's rotation-pair discipline (live file + one `.1`
aside, atomic rename at the byte cap) with NON-DURABLE appends, so the
zero-sync dispatch pipeline is never fenced by an fsync; a crash can
only tear the final line, which every reader here tolerates.

Knobs (environment, or config vars for World-owned exporters -- the
env spelling wins so operators can arm/disarm whole fleets):

    TPU_METRICS_HIST            1 (default) = append history at every
                                publish; 0 = byte-compatible no-op (no
                                ring file is ever created)
    TPU_METRICS_HIST_EVERY      sample every K-th publish (default 1 =
                                heartbeat cadence)
    TPU_METRICS_HIST_MAX_BYTES  rotation cap per ring file (default
                                4 MiB; the pair bounds disk at 2x)

Everything here is host-side bookkeeping: trajectories are bit-identical
with history on or off.  A copy of avida_tpu/observability/history.py;
it imports neither torch nor numpy, so `--status` reads the rings in a
process that never loads torch.
"""

from __future__ import annotations

import json
import os
import time

from avida_tpu_torch.observability.records import append_record

HIST_SUFFIX = ".hist.jsonl"
DEFAULT_MAX_BYTES = 4 << 20


def hist_path(prom_path: str) -> str:
    """The ring path beside a snapshot: `<dir>/metrics.prom` ->
    `<dir>/metrics.hist.jsonl` (non-.prom paths just append the
    suffix)."""
    base, ext = os.path.splitext(prom_path)
    if ext == ".prom":
        return base + HIST_SUFFIX
    return prom_path + HIST_SUFFIX


def parse_exposition(text: str) -> dict:
    """{name or name{labels}: float} from Prometheus exposition text --
    the string flavor of exporter.read_metrics, shared by the history
    sink so a sample row carries exactly what the publish rendered."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class HistoryKnobs:
    """Resolved TPU_METRICS_HIST* knobs.  `cfg` (an AvidaConfig, when
    the publisher owns one) supplies defaults; the environment wins so
    an operator can flip a whole fleet without touching configs."""

    def __init__(self, enabled: bool = True, every: int = 1,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.enabled = bool(enabled)
        self.every = max(int(every), 1)
        self.max_bytes = max(int(max_bytes), 1 << 14)

    @classmethod
    def resolve(cls, env=None, cfg=None) -> "HistoryKnobs":
        env = os.environ if env is None else env

        def knob(name, default):
            if name in env:
                return env[name]
            if cfg is not None:
                v = cfg.get(name, None)
                if v is not None:
                    return v
            return default

        return cls(enabled=int(knob("TPU_METRICS_HIST", 1)),
                   every=int(knob("TPU_METRICS_HIST_EVERY", 1)),
                   max_bytes=int(knob("TPU_METRICS_HIST_MAX_BYTES",
                                      DEFAULT_MAX_BYTES)))


class HistorySink:
    """Owns the ring beside one .prom path.  `publish(text)` is called
    by the exporter right after the snapshot rename with the exposition
    text it just wrote; appends are non-durable and never raise --
    history must not take down the heartbeat it is recording."""

    def __init__(self, prom_path: str, env=None, cfg=None,
                 knobs: HistoryKnobs | None = None):
        self.path = hist_path(prom_path)
        self.knobs = knobs or HistoryKnobs.resolve(env=env, cfg=cfg)
        self._publishes = 0

    def publish(self, text: str, now: float | None = None):
        if not self.knobs.enabled:
            return
        self._publishes += 1
        if (self._publishes - 1) % self.knobs.every:
            return
        try:
            values = parse_exposition(text)
            append_sample(self.path, values, now=now,
                          max_bytes=self.knobs.max_bytes)
        except Exception:
            pass


def append_sample(path: str, values: dict, now: float | None = None,
                  max_bytes: int = DEFAULT_MAX_BYTES):
    """Append one sample row to a ring, rotating at the byte cap (the
    records.append_record rotation-pair discipline, non-durable: no
    fsync -- a torn final line is tolerated by read_samples)."""
    rec = {"record": "sample",
           "time": round(time.time() if now is None else now, 3)}
    if "avida_update" in values:
        rec["update"] = int(values["avida_update"])
    rec["v"] = values
    append_record(path, rec, max_bytes=max_bytes, durable=False)


def read_samples(path: str, window_sec: float | None = None,
                 now: float | None = None,
                 tail_bytes: int | None = None) -> list:
    """Sample rows across the rotation pair (`<path>.1` then the live
    file), oldest first, torn/garbage lines skipped.  `window_sec`
    drops rows older than `now - window_sec`; `tail_bytes` caps how
    much of EACH file is read from the end (the alert evaluator's hot
    path -- a poll loop must not re-parse megabytes every tick)."""
    out = []
    for p in (path + ".1", path):
        try:
            with open(p, "rb") as f:
                if tail_bytes is not None:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    if size > tail_bytes:
                        f.seek(size - tail_bytes)
                        f.readline()        # skip the partial line
                    else:
                        f.seek(0)
                data = f.read()
        except OSError:
            continue
        for line in data.splitlines():
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if rec.get("record") != "sample" or "v" not in rec:
                continue
            out.append(rec)
    out.sort(key=lambda r: r.get("time", 0.0))
    if window_sec is not None:
        cutoff = (time.time() if now is None else now) - window_sec
        out = [r for r in out if r.get("time", 0.0) >= cutoff]
    return out


def series(samples: list, family: str, labels: str | None = None,
           agg=max) -> list:
    """[(time, value)] for one family, oldest first.  A bare family
    name matches both its unlabeled sample and every labeled row
    (`family{label}`); labeled rows collapse per sample through `agg`
    (default max).  An alert that should fire when ANY labeled series
    trips passes the aggregator matching its direction: max for
    above-threshold rules, min for below-threshold ones -- the worst
    series either way (observability/alerts.py picks this from the
    rule's op).  `labels` is a substring filter on the label part."""
    out = []
    prefix = family + "{"
    for rec in samples:
        vals = []
        for k, v in rec["v"].items():
            if k == family:
                vals.append(v)
            elif k.startswith(prefix):
                if labels is None or labels in k[len(prefix):-1]:
                    vals.append(v)
        if vals:
            out.append((rec.get("time", 0.0), agg(vals)))
    return out


def value_asof(points: list, t: float):
    """Step interpolation: the newest sample value at or before `t`
    (None when no sample that old exists)."""
    best = None
    for pt, pv in points:
        if pt <= t:
            best = pv
        else:
            break
    return best


def rate_over(points: list, t: float, window_sec: float):
    """Per-second rate of a (monotone or not) series over
    [t - window, t], step-interpolated: (v(t) - v(t - window)) /
    window.  None when the ring does not yet span the window -- a run
    that just started cannot honestly be called stalled.  A series
    whose newest sample predates the whole window still evaluates (the
    publisher stopped; its counter definitionally did not advance)."""
    if not points or window_sec <= 0:
        return None
    v_now = value_asof(points, t)
    v_then = value_asof(points, t - window_sec)
    if v_now is None or v_then is None:
        return None
    return (v_now - v_then) / window_sec


_QUANT = (0.5, 0.95)


def summarize(samples: list, family: str, window_sec: float | None = None,
              now: float | None = None, labels: str | None = None) -> dict:
    """Windowed digest of one family: count/min/max/p50/p95, first and
    last values, and the per-second rate across the window span --
    `metrics_tool.py query`'s engine."""
    now = time.time() if now is None else now
    if window_sec is not None:
        samples = [r for r in samples
                   if r.get("time", 0.0) >= now - window_sec]
    pts = series(samples, family, labels=labels)
    if not pts:
        return {"family": family, "count": 0}
    vals = sorted(v for _, v in pts)
    n = len(vals)

    def q(frac):
        return vals[min(int(frac * (n - 1) + 0.5), n - 1)]

    t0, v0 = pts[0]
    t1, v1 = pts[-1]
    span = t1 - t0
    return {
        "family": family, "count": n,
        "min": vals[0], "max": vals[-1],
        "p50": q(_QUANT[0]), "p95": q(_QUANT[1]),
        "first": v0, "last": v1,
        "span_sec": round(span, 3),
        "rate_per_sec": round((v1 - v0) / span, 6) if span > 0 else None,
    }


def recent_rate_line(path: str, family: str = "avida_update",
                     beats: int = 10, now: float | None = None) -> str:
    """The `--status` sparkline: per-second rate of a counter over the
    last `beats` ring samples, split into an older and a newer half so
    a trend reads at a glance (`upd/s last 10 beats: 12.1 -> 11.8`).
    Honest when there is nothing to summarize."""
    unit = "upd/s" if family == "avida_update" else f"{family}/s"
    samples = read_samples(path, tail_bytes=256 << 10)
    pts = series(samples, family)[-beats:]
    if len(pts) < 3:
        if not os.path.exists(path) and not os.path.exists(path + ".1"):
            return "no history (TPU_METRICS_HIST=0 or no publishes yet)"
        return f"no history ({len(pts)} sample(s) in the ring)"

    def seg_rate(seg):
        (t0, v0), (t1, v1) = seg[0], seg[-1]
        return (v1 - v0) / (t1 - t0) if t1 > t0 else 0.0

    mid = len(pts) // 2
    older = seg_rate(pts[:mid + 1])
    newer = seg_rate(pts[mid:])
    t_now = time.time() if now is None else now
    age = t_now - pts[-1][0]
    return (f"{unit} last {len(pts)} beats: {older:.2f} -> {newer:.2f}"
            f" (newest sample {age:.0f}s ago)")


def prune(path: str, keep_bytes: int = 256 << 10) -> dict:
    """`metrics_tool.py prune`: drop the `.1` aside and trim the live
    ring to its newest `keep_bytes` tail (whole lines, atomic rewrite).
    Returns {"removed_bytes": N, "kept_bytes": M}."""
    removed = 0
    try:
        removed += os.path.getsize(path + ".1")
        os.remove(path + ".1")
    except OSError:
        pass
    kept = 0
    try:
        size = os.path.getsize(path)
    except OSError:
        return {"removed_bytes": removed, "kept_bytes": 0}
    if size > keep_bytes:
        with open(path, "rb") as f:
            f.seek(size - keep_bytes)
            f.readline()                    # align to a whole line
            tail = f.read()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(tail)
        os.replace(tmp, path)
        removed += size - len(tail)
        kept = len(tail)
    else:
        kept = size
    return {"removed_bytes": removed, "kept_bytes": kept}
