"""Telemetry-history ops tool: query/watch/prune the .hist.jsonl rings.

Counterpart of the reference's scripts/metrics_tool.py.  Usage:

    python -m avida_tpu_torch.tools.metrics_tool query DIR FAMILY
            [--window SEC] [--ring NAME] [--labels SUBSTR] [--csv OUT.csv]
    python -m avida_tpu_torch.tools.metrics_tool watch DIR
            [--interval SEC] [--once] [--rules alerts.json]
    python -m avida_tpu_torch.tools.metrics_tool rules [DIR]
    python -m avida_tpu_torch.tools.metrics_tool prune DIR [--keep-bytes N]

DIR is a run data dir -- every `*.hist.jsonl` ring directly under it is
discovered: metrics.hist.jsonl (the run's heartbeat), multiworld.hist.jsonl
(a --worlds batch's rows) and supervisor.hist.jsonl (a supervised run's
counters; observability/history.py appends one beside each .prom
snapshot while TPU_METRICS_HIST=1).

  query   windowed digest of one family across the discovered rings
          (count/min/max/p50/p95, first->last, per-second rate);
          --csv exports the raw (time, update, value) rows.
  watch   the spectator's alert view: evaluate the declarative rule
          set (observability/alerts.py -- built-in defaults merged
          with DIR/alerts.json, or --rules) over the rings and print
          the firing table; loops every --interval (default 5s) until
          interrupted, or evaluates once with --once.  Exit status
          with --once: 0 = nothing firing, 3 = at least one rule
          firing (cron-able).  Runs armed with TPU_PROFILE=1 also
          publish the avida_perf_* attribution families
          (observability/profiler.py) -- query digests them like any
          family, and watch appends a perf row per ring that carries
          them.
  rules   print the effective rule set (after overrides) as JSON.
  prune   drop `.1` asides and trim live rings to a --keep-bytes tail
          (default 256 KiB), atomically.

Host-only: imports nothing that imports torch, so it runs anywhere the
data dir is mounted.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time

from avida_tpu_torch.observability import alerts, history


def find_rings(dirpath: str) -> list:
    """Every live history ring directly under `dirpath` (a data dir),
    sorted; `metrics` first so the run heartbeat wins ties."""
    rings = sorted(glob.glob(os.path.join(dirpath, "*" +
                                          history.HIST_SUFFIX)))
    rings.sort(key=lambda p: (0 if os.path.basename(p).startswith(
        "metrics.") else 1, p))
    return rings


def ring_name(path: str) -> str:
    return os.path.basename(path)[:-len(history.HIST_SUFFIX)]


def load_rings(rings: list, window_sec=None, now=None) -> dict:
    """{ring basename: sample rows}.  Rings are kept SEPARATE -- one
    family can mean different things in different rings (the batch
    aggregate in metrics vs the per-world rows in multiworld), so
    neither the alert evaluator nor query may blend them
    (alerts.samples_for)."""
    return {ring_name(p): history.read_samples(p, window_sec=window_sec,
                                               now=now)
            for p in rings}


def cmd_query(args) -> int:
    rings = find_rings(args.dir)
    if args.ring:
        rings = [p for p in rings
                 if os.path.basename(p) == args.ring + history.HIST_SUFFIX]
    if not rings:
        print(f"no history rings under {args.dir!r} "
              f"(TPU_METRICS_HIST=0, or nothing published yet)")
        return 1
    # one ring per query: the FIRST ring (metrics-first order) where
    # the family has samples in the window wins, and is named in the
    # output so a batch's per-world flavor is an explicit --ring
    # multiworld away
    by_ring = load_rings(rings, window_sec=args.window)
    samples, used, digest = [], None, None
    for p in rings:
        digest = history.summarize(by_ring[ring_name(p)], args.family,
                                   window_sec=args.window,
                                   labels=args.labels)
        if digest.get("count"):
            samples, used = by_ring[ring_name(p)], ring_name(p)
            break
    if used is None:
        print(f"family {args.family!r} has no samples in the window")
        return 1
    print(f"{'ring':<14} {used}")
    for k in ("family", "count", "min", "p50", "p95", "max", "first",
              "last", "span_sec", "rate_per_sec"):
        print(f"{k:<14} {digest.get(k)}")
    if args.csv:
        pts = history.series(
            [r for r in samples
             if args.window is None
             or r.get("time", 0.0) >= time.time() - args.window],
            args.family, labels=args.labels)
        upd = {r.get("time", 0.0): r.get("update")
               for r in samples if "update" in r}
        with open(args.csv, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["time", "update", args.family])
            for t, v in pts:
                wr.writerow([t, upd.get(t, ""), v])
        print(f"wrote {len(pts)} rows to {args.csv}")
    return 0


def _load_rules(args):
    return alerts.load_rules(args.dir,
                             rules_path=getattr(args, "rules", None))


def cmd_watch(args) -> int:
    rules = _load_rules(args)
    plane = alerts.AlertPlane(rules)     # no journal: spectators only
    while True:
        now = time.time()
        rings = find_rings(args.dir)
        by_ring = load_rings(rings, now=now)
        plane.observe(by_ring, now)
        n = sum(len(v) for v in by_ring.values())
        lines = [time.strftime("%H:%M:%S", time.localtime(now))
                 + f"  {len(rings)} ring(s), {n} sample(s)"]
        for name in sorted(plane.rules):
            state = "FIRING " if name in plane.firing else "ok     "
            val = plane.last_values.get(name)
            shown = "-" if val is None else (f"{val:.4g}")
            lines.append(f"  {state} {name:<28} value {shown:<12} "
                         f"fired {plane.fired_total[name]}x")
        # attribution-plane rider (TPU_PROFILE=1 runs): the latest
        # sample's perf families, one row per ring that carries them
        for rname in sorted(by_ring):
            rows = by_ring[rname]
            if not rows or "avida_perf_chunks_total" not in rows[-1]:
                continue
            s = rows[-1]
            lines.append(
                f"  perf    {rname:<28} chunk "
                f"{s.get('avida_perf_chunk_wall_ms', 0.0):.1f}ms wall / "
                f"{s.get('avida_perf_chunk_fenced_ms', 0.0):.1f}ms "
                f"fenced, {int(s.get('avida_perf_probes_total', 0))} "
                f"probes, state "
                f"{s.get('avida_perf_state_bytes', 0.0) / 2**20:.1f}MiB")
        print("\n".join(lines))
        if args.once:
            return 3 if plane.firing else 0
        sys.stdout.flush()
        time.sleep(args.interval)


def cmd_rules(args) -> int:
    rules = _load_rules(args)
    print(json.dumps([r.to_dict() for r in rules], indent=2))
    return 0


def cmd_prune(args) -> int:
    rings = find_rings(args.dir)
    # include orphaned .1 asides whose live file is gone
    asides = glob.glob(os.path.join(args.dir,
                                    "*" + history.HIST_SUFFIX + ".1"))
    rings += [p[:-2] for p in asides if p[:-2] not in rings]
    if not rings:
        print(f"no history rings under {args.dir!r}")
        return 0
    total = 0
    for p in sorted(set(rings)):
        res = history.prune(p, keep_bytes=args.keep_bytes)
        total += res["removed_bytes"]
        print(f"{p}: removed {res['removed_bytes']} bytes, "
              f"kept {res['kept_bytes']}")
    print(f"total removed: {total} bytes")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)

    q = sub.add_parser("query", help="windowed digest of one family")
    q.add_argument("dir")
    q.add_argument("family")
    q.add_argument("--window", type=float, default=None,
                   help="seconds of history to digest (default: all)")
    q.add_argument("--ring", default=None,
                   help="restrict to one ring (metrics/multiworld/"
                        "supervisor)")
    q.add_argument("--labels", default=None,
                   help="label substring filter for labeled families")
    q.add_argument("--csv", default=None, help="export raw rows here")

    w = sub.add_parser("watch", help="evaluate alert rules, print table")
    w.add_argument("dir")
    w.add_argument("--interval", type=float, default=5.0)
    w.add_argument("--once", action="store_true")
    w.add_argument("--rules", default=None,
                   help="alerts.json path (default: DIR/alerts.json "
                        "merged over built-ins)")

    r = sub.add_parser("rules", help="print the effective rule set")
    r.add_argument("dir", nargs="?", default=None)
    r.add_argument("--rules", default=None)

    pr = sub.add_parser("prune", help="trim rings, drop .1 asides")
    pr.add_argument("dir")
    pr.add_argument("--keep-bytes", type=int, default=256 << 10)

    args = p.parse_args(argv)
    try:
        return {"query": cmd_query, "watch": cmd_watch,
                "rules": cmd_rules, "prune": cmd_prune}[args.mode](args)
    except ValueError as e:
        print(f"[metrics_tool] {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0                      # `... | head` closed the pipe


if __name__ == "__main__":
    sys.exit(main())
