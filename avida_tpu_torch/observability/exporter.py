"""Prometheus-style metrics export: make a long run observable from outside.

Counterpart of avida_tpu/observability/exporter.py.  World.run rewrites
`DATA_DIR/metrics.prom` at every update-chunk boundary (atomic tmp +
rename) whenever TPU_METRICS=1 or the flight recorder (TPU_TRACE=1) is
on: `# HELP` / `# TYPE` comment pairs followed by `name value` lines, the
textfile-collector flavor of the Prometheus exposition format.
analyze/pipeline.py publishes DATA_DIR/analytics.prom through
render_families / write_metrics.

`python -m avida_tpu_torch --status DIR` is the human side of the same
file: it prints the last heartbeat without touching the running process,
and is answered before torch is imported (this module, history.py,
alerts.py, profiler.py and utils/integrity.py import no torch at module
level).

Live publishes are DEFERRED one chunk (capture the boundary's device
scalars by reference at boundary N, read them at boundary N+1 when that
chunk has finished), the same deferral the systematics newborn drain
and the flight-recorder drain use; only the exit heartbeat syncs.

ServeExporter is a serving batch's heartbeat (parallel/multiworld.
ServeBatch).  Both heartbeats carry the program cache's
avida_compile_cache_* families (utils/compilecache.py) once the process
touched the store, as the reference's do.
"""

from __future__ import annotations

import os
import time

import numpy as np

from avida_tpu_torch.observability import history, profiler
from avida_tpu_torch.utils import compilecache, integrity

METRICS_FILE = "metrics.prom"
MULTIWORLD_METRICS_FILE = "multiworld.prom"

_HELP = {
    "avida_update": ("counter", "updates completed by the run"),
    "avida_organisms": ("gauge", "living organisms at the last boundary"),
    "avida_births_total": ("counter", "cumulative births"),
    "avida_deaths_last_update": ("gauge", "deaths in the last update"),
    "avida_generation_avg": ("gauge", "population average generation"),
    "avida_time": ("counter", "avida time (sum of 1/ave_gestation)"),
    "avida_insts_total": ("counter", "organism instructions executed"),
    "avida_preempted": ("gauge", "1 after a SIGTERM/SIGINT preemption"),
    "avida_trace_events_total": ("counter",
                                 "flight-recorder events drained"),
    "avida_trace_dropped_total": ("counter",
                                  "flight-recorder events dropped "
                                  "(ring overflow, oldest first)"),
    "avida_trace_code_total": ("counter",
                               "flight-recorder events by code name"),
    "avida_heartbeat_timestamp_seconds": ("gauge",
                                          "unix time of the last export"),
    "avida_state_digest": ("gauge",
                           "order-stable u32 state digest at the last "
                           "digested chunk boundary (ops/digest.py)"),
    "avida_state_digest_update": ("gauge",
                                  "update the exported state digest "
                                  "describes"),
}


def _host(x):
    """A device scalar or vector (torch, on any device) or a host value
    as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def render_metrics(world) -> str:
    """The exposition text for a world's current host-visible state.
    This is the SYNCHRONOUS flavor -- `_flush_exec()` and the
    `np.asarray` readbacks fence any chunk still in flight -- so
    World.run uses it only for the exit/preempt final heartbeat; live
    chunk boundaries go through `MetricsExporter.export_deferred`, which
    never blocks the dispatch pipeline."""
    tracer = getattr(world, "tracer", None)
    organisms = (int(_host(world._prev_alive))
                 if world._prev_alive is not None
                 else (int(_host(world.state.alive).sum())
                       if world.state is not None else 0))
    values = {
        "avida_update": int(world.update),
        "avida_organisms": organisms,
        "avida_births_total": int(_host(world._total_births)),
        "avida_deaths_last_update": int(_host(world._deaths_this)),
        "avida_generation_avg": round(
            float(_host(world._last_ave_gen)), 4),
        "avida_time": round(float(_host(world._avida_time)), 6),
        "avida_insts_total": int(world._flush_exec()),
        "avida_preempted": int(bool(world.preempted or world._preempt)),
        "avida_heartbeat_timestamp_seconds": round(time.time(), 3),
    }
    digest = getattr(world, "state_digest", None)
    if digest is not None:
        # integrity plane armed (ops/digest.py): the last resolved
        # chunk-boundary digest + the update it describes.  Absent when
        # digesting is off, so those files stay byte-compatible.
        values["avida_state_digest"] = digest[1]
        values["avida_state_digest_update"] = digest[0]
    trace = None
    if tracer is not None:
        trace = (int(tracer.events_total), int(tracer.dropped_total),
                 dict(tracer.code_totals))
    return _render(values, trace)


def render_families(families) -> str:
    """Generic exposition renderer: families is an iterable of
    (name, kind, help, value) where value is a scalar or a
    {'label="x"': value} dict (one sample line per label set).  Shared
    by the run heartbeat below and the supervisor's own counter file
    (service/supervisor.py)."""
    lines = []
    for name, kind, help_, value in families:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        if isinstance(value, dict):
            for label, v in sorted(value.items()):
                lines.append(f"{name}{{{label}}} {v}")
        else:
            lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


def _render(values: dict, trace) -> str:
    """Exposition text from a resolved values dict (+ optional trace
    counter triple (events_total, dropped_total, code_totals)).  The
    integrity and profiler families ride every flavor of the run
    heartbeat (empty when their planes are off)."""
    if trace is not None:
        events_total, dropped_total, _ = trace
        values = dict(values,
                      avida_trace_events_total=events_total,
                      avida_trace_dropped_total=dropped_total)
    families = [(name, *_HELP[name], value)
                for name, value in values.items()]
    if trace is not None:
        families.append(
            ("avida_trace_code_total", *_HELP["avida_trace_code_total"],
             {f'code="{code}"': count
              for code, count in trace[2].items()}))
    families += compilecache.prom_families()
    families += integrity.prom_families()
    families += profiler.prom_families()
    return render_families(families)


def write_metrics(path: str, text: str, durable: bool = True):
    """Atomic publish: a scraper never sees a half-written file.
    `durable=False` skips the fsync -- the live chunk-boundary path uses
    it so a per-update boundary (event-forced stretch=1) never pays disk
    flush latency; the rename alone keeps the file torn-proof, and the
    final exit/preempt heartbeat republishes durably anyway."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def read_metrics(path: str) -> dict:
    """Parse an exposition file back into {name or name{labels}: float}
    (the file flavor of history.parse_exposition -- ONE parser, so ring
    samples can never disagree with .prom reads)."""
    with open(path) as f:
        return history.parse_exposition(f.read())


def format_status(metrics: dict, now: float | None = None,
                  hist_path: str | None = None) -> str:
    """Human-readable heartbeat digest of a metrics.prom dict.  With
    `hist_path` (the metrics history ring beside the snapshot,
    observability/history.py), a one-line recent-rate summary is
    appended -- honest "no history" when the ring is absent/short."""
    now = time.time() if now is None else now
    hb = metrics.get("avida_heartbeat_timestamp_seconds")
    age = f"{now - hb:.1f}s ago" if hb else "unknown"
    lines = [
        f"update      {int(metrics.get('avida_update', 0))}",
        f"organisms   {int(metrics.get('avida_organisms', 0))}",
        f"births      {int(metrics.get('avida_births_total', 0))}",
        f"insts       {int(metrics.get('avida_insts_total', 0))}",
        f"generation  {metrics.get('avida_generation_avg', 0.0):.2f}",
        f"heartbeat   {age}",
    ]
    if "avida_trace_events_total" in metrics:
        lines.append(
            f"trace       "
            f"{int(metrics['avida_trace_events_total'])} events, "
            f"{int(metrics.get('avida_trace_dropped_total', 0))} dropped")
    if "avida_compile_cache_hits_total" in metrics \
            or "avida_compile_cache_misses_total" in metrics:
        # persistent program cache (utils/compilecache.py): how this
        # process got its cycle library -- loaded from a verified entry
        # (hits) or built by nvcc (misses) -- and what each side cost
        lines.append(
            f"cache       "
            f"{int(metrics.get('avida_compile_cache_hits_total', 0))} "
            f"loads "
            f"({metrics.get('avida_compile_cache_load_ms_total', 0.0):.0f}"
            f"ms), "
            f"{int(metrics.get('avida_compile_cache_misses_total', 0))} "
            f"compiles "
            f"({metrics.get('avida_compile_cache_compile_ms_total', 0.0):.0f}"
            f"ms), "
            f"{int(metrics.get('avida_compile_cache_errors_total', 0))} "
            f"fallbacks")
    if "avida_state_digest" in metrics \
            or "avida_integrity_scrubs_total" in metrics:
        # integrity plane (ops/digest.py): the last boundary digest and
        # the scrub tally -- a nonzero mismatch count here means the
        # run ALREADY hit silent corruption and was rolled back
        parts = []
        if "avida_state_digest" in metrics:
            parts.append(
                f"digest {int(metrics['avida_state_digest']) & 0xFFFFFFFF:#010x}"
                f" @u{int(metrics.get('avida_state_digest_update', 0))}")
        parts.append(
            f"{int(metrics.get('avida_integrity_scrubs_total', 0))} "
            f"scrubs")
        parts.append(
            f"{int(metrics.get('avida_integrity_mismatches_total', 0))} "
            f"mismatches")
        lines.append("integrity   " + ", ".join(parts))
    perf_line = profiler.format_status_block(metrics)
    if perf_line is not None:
        # performance attribution plane (observability/profiler.py):
        # chunk walls, last probe's phase split, resident footprint
        lines.append(perf_line)
    if hist_path is not None:
        lines.append("history     "
                     + history.recent_rate_line(hist_path, now=now))
    if metrics.get("avida_preempted"):
        lines.append("preempted   yes (resume with --resume)")
    return "\n".join(lines)


def analytics_census_digest(analytics: dict,
                            metrics: dict | None = None) -> dict:
    """The census facts every status surface renders
    (analyze/pipeline.py's analytics.prom families): census update, its
    age against the run heartbeat's update counter (None without one),
    dominant gid/lineage depth, and the tasks-held mask + popcount.
    Shared by the single-run `--status` line below and the fleet
    per-tenant column (service/fleet.py) so the derivation lives once."""
    cu = int(analytics.get("avida_analytics_census_update", 0))
    age = None
    if metrics and "avida_update" in metrics:
        age = max(int(metrics["avida_update"]) - cu, 0)
    held = int(analytics.get("avida_analytics_tasks_held_mask", 0))
    return {
        "update": cu,
        "age": age,
        "gid": int(analytics.get("avida_analytics_dominant_genotype_id",
                                 -1)),
        "depth": int(analytics.get(
            "avida_analytics_dominant_lineage_depth", 0)),
        "tasks_mask": held,
        "tasks_held": bin(held).count("1"),
    }


def format_analytics_status(metrics: dict, analytics: dict) -> str:
    """One-line digest of an analytics.prom census for `--status`."""
    d = analytics_census_digest(analytics, metrics)
    age = "" if d["age"] is None else f" (age {d['age']} updates)"
    return (f"analytics   census @ update {d['update']}{age}, "
            f"dominant gid {d['gid']} depth {d['depth']}, "
            f"tasks {d['tasks_mask']:#x} ({d['tasks_held']} held)")


def multiworld_rows(mw: dict) -> dict:
    """{world_name: {family: value}} from a multiworld.prom dict --
    the per-world {world="..."} labeled samples regrouped by world.
    Shared by the `--status` view below and the fleet per-tenant
    sub-rows (service/fleet.py) so the parse lives once."""
    rows: dict = {}
    for k, v in mw.items():
        if '{world="' not in k:
            continue
        fam, label = k.split('{world="', 1)
        rows.setdefault(label.rstrip('"}'), {})[fam] = v
    return rows


def format_multiworld_status(mw: dict) -> str:
    """The batch block of `--status` for a --worlds run: one batch
    summary line (size, in-program batch efficiency, worst straggler)
    plus one sub-row per world with its straggler lag."""
    size = int(mw.get("avida_multiworld_size", 0))
    eff = mw.get("avida_multiworld_batch_efficiency")
    rows = multiworld_rows(mw)
    lags = {n: float(d.get("avida_multiworld_straggler_lag_updates", 0.0))
            for n, d in rows.items()}
    head = f"batch       {size} worlds"
    if eff is not None:
        head += f", efficiency {float(eff):.2f}"
    if lags:
        head += f", worst straggler lag {max(lags.values()):.1f}u"
    lines = [head]
    for n in sorted(rows):
        d = rows[n]
        lines.append(
            f"  {n:<18} u{int(d.get('avida_update', 0))} "
            f"organisms {int(d.get('avida_organisms', 0))} "
            f"lag {lags.get(n, 0.0):.1f}u")
    return "\n".join(lines)


def status_main(data_dir: str, max_age: float | None = None) -> int:
    """`python -m avida_tpu_torch --status DIR [--max-age SEC]`: print the
    last heartbeat.  Exit status is machine-consumable so external
    watchdogs/cron can alert on it: 0 = heartbeat present (and fresh,
    when --max-age is given), 1 = no metrics file, 2 = heartbeat missing
    from the file or staler than max_age seconds."""
    path = os.path.join(data_dir, METRICS_FILE)
    if not os.path.exists(path):
        print(f"no {METRICS_FILE} under {data_dir!r} (run with "
              f"TPU_METRICS=1 or TPU_TRACE=1)")
        return 1
    metrics = read_metrics(path)
    print(format_status(metrics, hist_path=history.hist_path(path)))
    mw_path = os.path.join(data_dir, MULTIWORLD_METRICS_FILE)
    if os.path.exists(mw_path):
        print(format_multiworld_status(read_metrics(mw_path)))
    sup_path = os.path.join(data_dir, "supervisor.prom")
    if os.path.exists(sup_path):
        sup = read_metrics(sup_path)
        fails = sum(v for k, v in sup.items()
                    if k.startswith("avida_supervisor_failures_total"))
        print(f"supervisor  boots {int(sup.get('avida_supervisor_boots_total', 0))}, "
              f"failures {int(fails)}, "
              f"budget {int(sup.get('avida_supervisor_retry_budget', 0))}")
        # alert column (observability/alerts.py): the supervisor's poll
        # loop evaluates the rule set over the history rings and
        # exports firing/fired families on its own .prom file
        from avida_tpu_torch.observability.alerts import format_alert_status
        alert_line = format_alert_status(sup)
        if alert_line is not None:
            print(alert_line)
    ana_path = os.path.join(data_dir, "analytics.prom")
    if os.path.exists(ana_path):
        print(format_analytics_status(metrics, read_metrics(ana_path)))
    if max_age is not None:
        hb = metrics.get("avida_heartbeat_timestamp_seconds")
        age = None if hb is None else time.time() - hb
        if age is None or age > max_age:
            shown = "missing" if age is None else f"{age:.1f}s"
            print(f"STALE: heartbeat {shown} exceeds --max-age {max_age}s")
            return 2
    return 0


def _owner_cfg(owner):
    """The AvidaConfig governing a batch publisher's history knobs: its
    own cfg when it has one, else the first member world's (every
    member of a batch shares the static config that matters here)."""
    cfg = getattr(owner, "cfg", None)
    if cfg is None:
        worlds = getattr(owner, "worlds", None) or ()
        for w in worlds:
            if w is not None and getattr(w, "cfg", None) is not None:
                return w.cfg
    return cfg


class MetricsExporter:
    """Owns the metrics.prom path for one World.  `export()` republishes
    synchronously (run exit / preemption -- the values must be final);
    `export_deferred()` is the live chunk-boundary path and never fences
    the device."""

    def __init__(self, world, path: str | None = None):
        self.world = world
        self.path = path or os.path.join(world.data_dir, METRICS_FILE)
        self._pending = None
        # time-series ring beside the snapshot (observability/history.py):
        # one compact sample row per publish, TPU_METRICS_HIST* knobs
        # resolved env-over-config once here
        self.hist = history.HistorySink(self.path,
                                        cfg=getattr(world, "cfg", None))

    def export(self, world=None):
        text = render_metrics(world or self.world)
        write_metrics(self.path, text)
        self.hist.publish(text)

    def export_deferred(self, world=None):
        """Chunk-boundary publish with the same one-chunk deferral as the
        newborn/trace drains: capture the boundary's device scalars by
        REFERENCE now (no readback -- resolving them would fence the
        chunk just dispatched), publish the PREVIOUS boundary's capture,
        whose chunk has long finished, so `np.asarray` there is a free
        readback.  The heartbeat therefore lags live state by exactly one
        chunk, inside the "within one chunk" freshness contract."""
        w = world or self.world
        prev, self._pending = self._pending, self._snapshot(w)
        if prev is not None:
            text = self._render_snapshot(prev)
            write_metrics(self.path, text, durable=False)
            self.hist.publish(text)

    @staticmethod
    def _snapshot(w) -> dict:
        tracer = getattr(w, "tracer", None)
        return {
            "update": int(w.update),
            "organisms": w._prev_alive,      # device refs: reassigned
            "births": w._total_births,       # (not mutated) each chunk,
            "deaths": w._deaths_this,        # so holding them is safe
            "gen": w._last_ave_gen,
            "time": w._avida_time,
            # last host-flushed total: draining _pending_exec here would
            # be the very fence this path exists to avoid
            "insts": int(w._cum_insts),
            "preempted": int(bool(w.preempted or w._preempt)),
            "trace": ((int(tracer.events_total), int(tracer.dropped_total),
                       dict(tracer.code_totals))
                      if tracer is not None else None),
            # last RESOLVED digest (the integrity plane's own one-chunk
            # deferral): already a host value, no readback here
            "digest": getattr(w, "state_digest", None),
        }

    @staticmethod
    def _render_snapshot(snap: dict) -> str:
        values = {
            "avida_update": snap["update"],
            "avida_organisms": (int(_host(snap["organisms"]))
                                if snap["organisms"] is not None else 0),
            "avida_births_total": int(_host(snap["births"])),
            "avida_deaths_last_update": int(_host(snap["deaths"])),
            "avida_generation_avg": round(
                float(_host(snap["gen"])), 4),
            "avida_time": round(float(_host(snap["time"])), 6),
            "avida_insts_total": snap["insts"],
            "avida_preempted": snap["preempted"],
            "avida_heartbeat_timestamp_seconds": round(time.time(), 3),
        }
        if snap.get("digest") is not None:
            values["avida_state_digest"] = snap["digest"][1]
            values["avida_state_digest_update"] = snap["digest"][0]
        return _render(values, snap["trace"])


class MultiWorldExporter:
    """Heartbeat for one MultiWorld batch (parallel/multiworld.py).

    Publishes TWO files into the batch's root data dir:

      metrics.prom      the standard single-run families carrying batch
                        AGGREGATES (update = the shared grid counter;
                        organisms / births / insts summed over worlds),
                        so the supervisor watchdog, `--status DIR` and
                        every other metrics.prom consumer read a
                        batched child exactly like a solo run;
      multiworld.prom   the per-world rows: the same families labeled
                        {world="<name>"} -- one sample per batch member
                        -- plus avida_multiworld_size.

    Live publishes are deferred one chunk (capture [W]-vector refs at
    boundary N, read them back at boundary N+1 when that chunk has
    finished) exactly like MetricsExporter; export_final is the
    synchronous exit/preempt flavor."""

    _PER_WORLD = ("avida_update", "avida_organisms", "avida_births_total",
                  "avida_deaths_last_update", "avida_generation_avg",
                  "avida_time", "avida_insts_total", "avida_preempted")

    def __init__(self, mw, path: str | None = None):
        self.mw = mw
        base = path or mw.data_dir
        self.path = os.path.join(base, METRICS_FILE)
        self.worlds_path = os.path.join(base, MULTIWORLD_METRICS_FILE)
        self._pending = None
        cfg = _owner_cfg(mw)
        self.hist = history.HistorySink(self.path, cfg=cfg)
        self.worlds_hist = history.HistorySink(self.worlds_path, cfg=cfg)

    def export_deferred(self, mw=None):
        m = mw or self.mw
        prev, self._pending = self._pending, self._snapshot(m)
        if prev is not None:
            self._publish(prev, durable=False)

    def export_final(self, mw=None):
        m = mw or self.mw
        for w in m.worlds:
            # the exit heartbeat must carry exact totals (solo
            # render_metrics flushes too); a fleet leader world shares
            # the root data dir, so no per-world export flushed for it
            w._flush_exec()
        self._pending = None
        self._publish(self._snapshot(m), durable=True)

    @staticmethod
    def _snapshot(mw) -> dict:
        return {
            "update": int(mw.update),
            "names": list(mw.names),
            "organisms": mw._prev_alive,       # [W] device refs; the
            "births": mw._total_births,        # batch loop reassigns
            "deaths": mw._deaths_this,         # (never mutates) them
            "gen": mw._last_ave_gen,
            "time": mw._avida_time,
            "insts": [int(w._cum_insts) for w in mw.worlds],
            "preempted": int(bool(mw.preempted or mw._preempt)),
            # occupancy accumulators (parallel/multiworld._scan): [W]
            # per-world trip totals, the per-update batch-max total, and
            # the update count they cover -> batch_efficiency gauge +
            # per-world straggler-lag rows
            "trips": getattr(mw, "_trips", None),
            "leader_trips": getattr(mw, "_leader_trips", None),
            "trips_updates": int(getattr(mw, "_trips_updates", 0)),
            # (update, [W] values) -- already host-resolved by the
            # integrity plane's own deferral; None when digesting is off
            "digests": getattr(mw, "state_digests", None),
        }

    def _publish(self, snap: dict, durable: bool):
        def vec(x, default=0):
            if x is None:
                return [default] * len(snap["names"])
            return _host(x).tolist()

        per = {
            "avida_update": [snap["update"]] * len(snap["names"]),
            "avida_organisms": vec(snap["organisms"]),
            "avida_births_total": vec(snap["births"]),
            "avida_deaths_last_update": vec(snap["deaths"]),
            "avida_generation_avg": [round(float(v), 4)
                                     for v in vec(snap["gen"], 0.0)],
            "avida_time": [round(float(v), 6)
                           for v in vec(snap["time"], 0.0)],
            "avida_insts_total": snap["insts"],
            "avida_preempted": [snap["preempted"]] * len(snap["names"]),
        }
        agg = {
            "avida_update": snap["update"],
            "avida_organisms": int(sum(per["avida_organisms"])),
            "avida_births_total": int(sum(per["avida_births_total"])),
            "avida_deaths_last_update": int(
                sum(per["avida_deaths_last_update"])),
            "avida_generation_avg": round(
                float(np.mean(per["avida_generation_avg"])), 4),
            "avida_time": round(max(per["avida_time"]), 6),
            "avida_insts_total": int(sum(snap["insts"])),
            "avida_preempted": snap["preempted"],
            "avida_heartbeat_timestamp_seconds": round(time.time(), 3),
        }
        try:
            text = _render(agg, None)
            write_metrics(self.path, text, durable=durable)
            self.hist.publish(text)
            fams = [("avida_multiworld_size", "gauge",
                     "worlds batched into this run", len(snap["names"]))]
            fams += [(name, *_HELP[name],
                      {f'world="{n}"': v
                       for n, v in zip(snap["names"], per[name])})
                     for name in self._PER_WORLD]
            fams += self._occupancy_families(snap)
            if snap.get("digests") is not None:
                du, dvals = snap["digests"]
                fams.append(
                    ("avida_state_digest", *_HELP["avida_state_digest"],
                     {f'world="{n}"': v
                      for n, v in zip(snap["names"], dvals)}))
                fams.append(("avida_state_digest_update",
                             *_HELP["avida_state_digest_update"], du))
            fams.append(("avida_heartbeat_timestamp_seconds",
                         *_HELP["avida_heartbeat_timestamp_seconds"],
                         round(time.time(), 3)))
            wtext = render_families(fams)
            write_metrics(self.worlds_path, wtext, durable=durable)
            self.worlds_hist.publish(wtext)
        except OSError:
            pass                    # metrics must never kill the batch

    @staticmethod
    def _occupancy_families(snap: dict) -> list:
        """The world-axis occupancy gauges (PR-11 satellite).

        batch_efficiency = sum_w(trips_w) / (W * leader_trips): the
        fraction of the batch's lockstep trip-count budget doing
        per-world useful work (1.0 = every world wanted exactly the
        batch-max trips every update; the structural ceiling of
        in-program batching -- what the world-folded cycle loop /
        stacked kernel can actually deliver of it is bench.py's
        batch_efficiency throughput ratio).

        straggler_lag_updates{world=w} = (leader_trips - trips_w) /
        (leader_trips / updates): how many batch-leader updates' worth
        of cycles world w sat masked while faster tenants ran -- 0 for
        the leader, growing for a tenant whose budgets trail the
        batch."""
        trips = snap.get("trips")
        if trips is None or not snap["names"]:
            return []
        tl = [float(v) for v in _host(trips).tolist()]
        leader = float(_host(snap.get("leader_trips") or 0.0))
        if leader <= 0:
            # no cycle work yet (or an extinct batch): absent gauges,
            # never a falsely-perfect 1.0
            return []
        upd_n = int(snap.get("trips_updates") or 0)
        W = len(snap["names"])
        eff = sum(tl) / (W * leader)
        per_upd = (leader / upd_n) if upd_n else 0.0
        lag = [round((leader - t) / per_upd, 2) if per_upd > 0 else 0.0
               for t in tl]
        return [
            ("avida_multiworld_batch_efficiency", "gauge",
             "sum of per-world trip counts / (W x batch-max trips): "
             "in-program batching occupancy, 1.0 = no straggler waste",
             round(eff, 4)),
            ("avida_multiworld_straggler_lag_updates", "gauge",
             "batch-leader updates' worth of cycles this world spent "
             "masked behind faster tenants",
             {f'world="{n}"': v for n, v in zip(snap["names"], lag)}),
        ]


class ServeExporter:
    """Heartbeat for a ServeBatch (parallel/multiworld.ServeBatch, the
    streaming serve layer).

    Publishes the same two files as MultiWorldExporter -- metrics.prom
    (the batch aggregate: the supervisor's watchdog and --status read a
    serve child exactly like a solo run, and an idle class keeps its
    watchdog fed through it) and multiworld.prom (per-world
    {world="tenant"} rows for the LIVE slots) -- plus the serve families:
    padded width, live and ghost slot counts, admission / retirement /
    boundary counters and the build count (`avida_serve_compiles_total`,
    the reference's family name: this process's nvcc builds of the cycle
    library).  Publishes are synchronous: the serve loop exports at
    checkpoint boundaries and idle ticks, where the batch is already
    host-synced."""

    _PER_WORLD = ("avida_update", "avida_organisms", "avida_births_total",
                  "avida_generation_avg", "avida_insts_total")

    def __init__(self, sb, path: str | None = None):
        self.sb = sb
        base = path or sb.data_dir
        self.path = os.path.join(base, METRICS_FILE)
        self.worlds_path = os.path.join(base, MULTIWORLD_METRICS_FILE)
        cfg = _owner_cfg(sb)
        self.hist = history.HistorySink(self.path, cfg=cfg)
        self.worlds_hist = history.HistorySink(self.worlds_path, cfg=cfg)

    def export(self, sb=None, durable: bool = False):
        from avida_tpu_torch.ops import cycles
        sb = sb or self.sb
        live = sb._live()
        rows = {}
        for i, w in live:
            organisms = (int(_host(w._prev_alive))
                         if w._prev_alive is not None
                         else (int(_host(w.state.alive).sum())
                               if w.state is not None else 0))
            rows[sb.names[i]] = {
                "avida_update": int(w.update),
                "avida_organisms": organisms,
                "avida_births_total": int(_host(w._total_births)),
                "avida_generation_avg": round(
                    float(_host(w._last_ave_gen)), 4),
                "avida_insts_total": int(w._flush_exec()),
            }
        agg = {
            "avida_update": max([r["avida_update"] for r in rows.values()],
                                default=0),
            "avida_organisms": sum(r["avida_organisms"]
                                   for r in rows.values()),
            "avida_births_total": sum(r["avida_births_total"]
                                      for r in rows.values()),
            "avida_insts_total": sum(r["avida_insts_total"]
                                     for r in rows.values()),
            "avida_preempted": int(bool(sb.preempted or sb._preempt)),
            "avida_heartbeat_timestamp_seconds": round(time.time(), 3),
        }
        fams = [(name, *_HELP[name], value)
                for name, value in agg.items()]
        serve_fams = [
            ("avida_serve_width", "gauge",
             "padded batch width of this serving class", sb.width),
            ("avida_serve_live_worlds", "gauge",
             "slots occupied by live tenants", sb.num_live),
            ("avida_serve_ghost_slots", "gauge",
             "inert ghost slots holding the batch's shape",
             sb.num_ghosts),
            ("avida_serve_admissions_total", "counter",
             "tenants promoted into this batch", sb.admissions),
            ("avida_serve_retirements_total", "counter",
             "tenants retired from this batch (done/demoted)",
             sb.retirements),
            ("avida_serve_boundaries_total", "counter",
             "checkpoint boundaries crossed (the promotion grid)",
             sb.boundaries),
            ("avida_serve_compiles_total", "counter",
             "nvcc builds of the cycle library run by this process "
             "(flat after warm-up: no admission waits on a build)",
             cycles.BUILDS),
        ] + compilecache.prom_families() + integrity.prom_families() \
            + profiler.prom_families()
        per_fams = [(name, *_HELP[name],
                     {f'world="{n}"': r[name] for n, r in rows.items()})
                    for name in self._PER_WORLD if rows]
        snap = {"names": [sb.names[i] for i, _ in live],
                "trips": (None if sb._trips is None else
                          _host(sb._trips)[[i for i, _ in live]]),
                "leader_trips": sb._leader_trips,
                "trips_updates": sb._trips_updates}
        occ = MultiWorldExporter._occupancy_families(snap)
        try:
            text = render_families(fams + serve_fams)
            write_metrics(self.path, text, durable=durable)
            self.hist.publish(text)
            fams2 = [("avida_multiworld_size", "gauge",
                      "live tenants in this serving batch", sb.num_live)]
            fams2 += per_fams + serve_fams + occ
            fams2.append(("avida_heartbeat_timestamp_seconds",
                          *_HELP["avida_heartbeat_timestamp_seconds"],
                          round(time.time(), 3)))
            wtext = render_families(fams2)
            write_metrics(self.worlds_path, wtext, durable=durable)
            self.worlds_hist.publish(wtext)
        except OSError:
            pass                    # metrics must never kill serving
