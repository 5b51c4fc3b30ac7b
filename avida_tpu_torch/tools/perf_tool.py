"""Performance attribution ops tool: report / diff / campaign.
Counterpart of the reference's scripts/perf_tool.py; it loads no torch.

Usage:
    python -m avida_tpu_torch.tools.perf_tool report DIR
    python -m avida_tpu_torch.tools.perf_tool diff A.json B.json [--gate]
            [--tol 0.10] [--force]
    python -m avida_tpu_torch.tools.perf_tool campaign ...

  report    one-page attribution summary of a run data dir: the
            avida_perf_* families from metrics.prom (chunk walls, the
            CUDA-event device time of probed chunks, last probed phases,
            state footprint, the card's allocator counters) plus the
            perf.jsonl probe timeline (observability/profiler.py; arm
            the run with TPU_PROFILE=1).  The port compiles no XLA
            programs, so the reference's per-program block
            (avida_perf_program_*) has no rows here.
  diff      compare two bench artifacts field by field.  Refuses
            apples-to-oranges pairs LOUDLY (exit 3) when the strict
            provenance fields -- platform, device_kind, device_count,
            x64, code digest -- disagree (--force compares anyway).
            Direction is keyed by field spelling: `value`,
            *_inst_per_sec and speedup* are higher-better; *_ms,
            *_sec and *_pct are lower-better; everything else is
            informational.  With --gate, any regression beyond --tol
            (default 10%) exits 4.
  campaign  the reference's multi-arm bench runner.  The port has no bench yet
            (ROADMAP item 8), so it is refused by name (exit 2).

Exit status: 0 ok; 2 usage/unreadable input (and campaign); 3
provenance mismatch; 4 regression found with --gate.
"""

from __future__ import annotations

import argparse
import os
import sys

from avida_tpu_torch.observability import perfread

# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def cmd_report(args) -> int:
    prom = {}
    for fname in ("metrics.prom", "multiworld.prom"):
        prom = perfread.read_prom(os.path.join(args.dir, fname))
        if any(k.startswith("avida_perf") for k in prom):
            break
    recs = perfread.read_perf_records(args.dir)
    if not any(k.startswith("avida_perf") for k in prom) and not recs:
        print(f"no attribution data under {args.dir!r} "
              f"(run with TPU_PROFILE=1; see README "
              f"'Performance attribution')")
        return 1

    def g(name, default=0.0):
        return prom.get(name, default)

    print(f"perf report  {args.dir}")
    print(f"  chunks {int(g('avida_perf_chunks_total'))} covering "
          f"{int(g('avida_perf_updates_total'))} updates, "
          f"{int(g('avida_perf_probes_total'))} fenced probes")
    print(f"  chunk wall {g('avida_perf_chunk_wall_ms'):.1f}ms unfenced "
          f"/ {g('avida_perf_chunk_fenced_ms'):.1f}ms fenced; probe "
          f"{g('avida_perf_probe_ms'):.1f}ms")
    if "avida_perf_chunk_device_ms" in prom:
        print(f"  chunk device {g('avida_perf_chunk_device_ms'):.1f}ms "
              f"(CUDA events, probed chunks)")
    phases = {k.split('phase="', 1)[1].rstrip('"}'): v
              for k, v in prom.items()
              if k.startswith('avida_perf_phase_ms{')}
    if phases:
        total = sum(phases.values()) or 1.0
        print("  phases (last probe):")
        for n, v in sorted(phases.items(), key=lambda kv: -kv[1]):
            print(f"    {n:<14} {v:9.2f}ms  {v / total * 100:5.1f}%")
    if "avida_perf_cycle_loop_share" in prom:
        print(f"  cycle loop share "
              f"{g('avida_perf_cycle_loop_share'):.1%}")
    if "avida_perf_state_bytes" in prom:
        tb = g("avida_perf_state_bytes")
        lb = g("avida_perf_state_live_bytes")
        line = (f"  state {tb / 2**20:.2f}MiB padded, "
                f"{lb / 2**20:.2f}MiB live "
                f"({(lb / tb * 100) if tb else 0:.0f}%)")
        if "avida_perf_world_state_bytes" in prom:
            line += (f"; {g('avida_perf_world_state_bytes') / 2**20:.2f}"
                     f"MiB/world")
        if "avida_perf_ghost_state_bytes" in prom:
            line += (f", {g('avida_perf_ghost_state_bytes') / 2**20:.2f}"
                     f"MiB ghost")
        print(line)
        leaves = sorted(((k.split('leaf="', 1)[1].rstrip('"}'), v)
                         for k, v in prom.items()
                         if k.startswith('avida_perf_state_leaf_bytes{')),
                        key=lambda kv: -kv[1])
        if leaves:
            print("  largest leaves: " + ", ".join(
                f"{n} {v / 1024:.0f}KiB" for n, v in leaves[:6]))
    if "avida_perf_device_allocated_bytes" in prom:
        print(f"  card memory "
              f"{g('avida_perf_device_allocated_bytes') / 2**20:.2f}MiB "
              f"allocated, "
              f"{g('avida_perf_device_peak_allocated_bytes') / 2**20:.2f}"
              f"MiB peak, "
              f"{g('avida_perf_device_reserved_bytes') / 2**20:.2f}MiB "
              f"reserved")
    if recs:
        print(f"  probe timeline ({len(recs)} perf.jsonl records):")
        for r in recs[-8:]:
            tag = "final" if r.get("final") else "probe"
            ph = r.get("phases") or {}
            top = max(ph, key=ph.get) if ph else "-"
            print(f"    u={r.get('update', 0):<8} {tag:<6} "
                  f"wall {r.get('chunk_wall_ms', 0):8.1f}ms  "
                  f"state {r.get('state_bytes', 0) / 2**20:6.2f}MiB  "
                  f"top phase {top}")
    return 0


# ---------------------------------------------------------------------------
# diff (the regression gate)
# ---------------------------------------------------------------------------


def _flatten(obj, prefix="") -> dict:
    """Dotted numeric scalars of a bench line; provenance and lists
    stay out of the comparison."""
    out = {}
    for k, v in obj.items():
        if k == "provenance":
            continue
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, bool):
            continue
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out


def _direction(key: str) -> int:
    """+1 higher-better, -1 lower-better, 0 informational.  Keyed by
    the bench field spellings (throughputs and speedups up; walls,
    latencies and overhead shares down)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "value" or leaf.endswith("_inst_per_sec") \
            or "speedup" in leaf or leaf.endswith("_efficiency"):
        return 1
    if leaf.endswith(("_ms", "_sec", "_pct")):
        return -1
    return 0


def diff_lines(a: dict, b: dict, tol: float) -> tuple:
    """(rows, regressions): every shared numeric field compared, the
    direction-aware failures beyond `tol` collected."""
    fa, fb = _flatten(a), _flatten(b)
    rows, regressions = [], []
    for key in sorted(set(fa) & set(fb)):
        va, vb = fa[key], fb[key]
        delta = (vb - va) / abs(va) if va else (0.0 if vb == va else
                                                float("inf"))
        d = _direction(key)
        verdict = "info"
        if d:
            worse = delta < -tol if d > 0 else delta > tol
            better = delta > tol if d > 0 else delta < -tol
            verdict = ("REGRESSION" if worse
                       else "improved" if better else "ok")
        if verdict == "REGRESSION":
            regressions.append((key, va, vb, delta))
        rows.append((key, va, vb, delta, verdict))
    return rows, regressions


def cmd_diff(args) -> int:
    try:
        a = perfread.load_bench_json(args.a)
        b = perfread.load_bench_json(args.b)
    except (OSError, ValueError) as e:
        print(f"[perf_tool] unreadable artifact: {e}", file=sys.stderr)
        return 2
    # campaign artifacts diff arm-by-arm; plain lines diff directly
    arms_a = a.get("arms") if a.get("artifact") else None
    arms_b = b.get("arms") if b.get("artifact") else None
    prov_a = a.get("provenance") or next(
        (v.get("provenance") for v in (arms_a or {}).values()
         if v.get("provenance")), None)
    prov_b = b.get("provenance") or next(
        (v.get("provenance") for v in (arms_b or {}).values()
         if v.get("provenance")), None)
    mismatches = perfread.provenance_mismatches(prov_a or {}, prov_b or {})
    if mismatches:
        print("[perf_tool] REFUSING apples-to-oranges diff -- strict "
              "provenance fields disagree:", file=sys.stderr)
        for f, va, vb in mismatches:
            print(f"  {f}: {va!r} vs {vb!r}", file=sys.stderr)
        if not args.force:
            print("  (--force compares anyway)", file=sys.stderr)
            return 3
    if arms_a is not None or arms_b is not None:
        pairs = [(f"{name}.", (arms_a or {}).get(name),
                  (arms_b or {}).get(name))
                 for name in sorted(set(arms_a or {}) | set(arms_b or {}))]
    else:
        pairs = [("", a, b)]
    rows, regressions = [], []
    for prefix, la, lb in pairs:
        if not (la and lb):
            print(f"  arm {prefix.rstrip('.')}: only in one artifact, "
                  f"skipped")
            continue
        r, bad = diff_lines(la, lb, args.tol)
        rows += [(prefix + k, va, vb, d, v) for k, va, vb, d, v in r]
        regressions += [(prefix + k, va, vb, d) for k, va, vb, d in bad]
    width = max((len(k) for k, *_ in rows), default=10)
    print(f"{'field':<{width}}  {'A':>14}  {'B':>14}  {'delta':>8}  "
          f"verdict")
    for key, va, vb, delta, verdict in rows:
        if verdict == "info" and not args.verbose:
            continue
        print(f"{key:<{width}}  {va:>14.4g}  {vb:>14.4g}  "
              f"{delta * 100:>+7.1f}%  {verdict}")
    if regressions:
        print(f"{len(regressions)} regression(s) beyond "
              f"{args.tol:.0%} tolerance")
        return 4 if args.gate else 0
    print("no regressions" + ("" if args.gate else
                              " (advisory; --gate makes this binding)"))
    return 0


# ---------------------------------------------------------------------------
# campaign
# ---------------------------------------------------------------------------


def cmd_campaign(args) -> int:
    print("[perf_tool] campaign: refused -- it runs bench.py arms, and the "
          "port has no bench yet (ROADMAP item 8); report and diff read "
          "the artifacts a bench writes", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)

    r = sub.add_parser("report", help="one-page attribution summary")
    r.add_argument("dir")

    d = sub.add_parser("diff", help="compare two bench artifacts")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--gate", action="store_true",
                   help="exit 4 on any regression beyond --tol")
    d.add_argument("--tol", type=float, default=0.10,
                   help="relative tolerance (default 0.10)")
    d.add_argument("--force", action="store_true",
                   help="compare despite a provenance mismatch")
    d.add_argument("--verbose", action="store_true",
                   help="also print direction-less info fields")

    c = sub.add_parser("campaign",
                       help="refused until the port's bench (ROADMAP "
                            "item 8)")

    # campaign takes the reference's options only to refuse them
    args, extra = p.parse_known_args(argv)
    if extra and args.mode != "campaign":
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return {"report": cmd_report, "diff": cmd_diff,
                "campaign": cmd_campaign}[args.mode](args)
    except ValueError as e:
        print(f"[perf_tool] {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(main())
