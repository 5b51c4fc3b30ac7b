"""Command line: `python -m avida_tpu_torch [-u N] [-s SEED] [-d DIR]
[-c CONFIG_DIR] [-set NAME VALUE ...] [--device cuda|cpu]
[--worlds SEEDS|MANIFEST] [--serve-worlds CONTROL] [-a [CKPT_DIR]]
[--telemetry] [--profile-dir DIR] [--trace] [--status DIR [--max-age SEC]]
[-v]`, `python -m avida_tpu_torch --supervise [--fault-plan SPECS]
ARGS...`, and `python -m avida_tpu_torch --fleet SPOOL [--max-jobs N]
[--serve] [--dynamic]`.

Runs one world and writes its .dat files, with the reference's defaults
(systematics on: the per-update engine; -set TPU_SYSTEMATICS 0 takes the
packed-resident engine; -set TPU_USE_PALLAS 2 the micro-step engine).
--worlds runs a batch of static-equal worlds with the update's cycles run
once for the whole batch
(parallel/multiworld.py): SEEDS is a comma list ("7,8,9"; world k writes
to DATA_DIR/w00k), MANIFEST a worlds.json path ([{"name", "seed",
"data_dir", "ckpt_dir"}]).  A batch the configuration refuses exits 2
with the reason.

Persistence: -set TPU_CKPT_DIR DIR checkpoints the run (every
TPU_CKPT_EVERY updates, at the end with TPU_CKPT_FINAL 1, and on
SIGTERM/SIGINT, which stop the run cleanly with exit 0).  --resume [DIR]
continues a solo run from the newest valid generation under DIR (default
TPU_CKPT_DIR); an empty directory starts fresh.  With --worlds, --resume
(no DIR) resumes every member from its own checkpoint dir, aligned on a
common update.  Exit codes as the reference's: 66 no valid generation,
65 an invariant audit failed, 67 a scrub found a divergence.

Serving: --serve-worlds CONTROL runs a serving batch
(parallel/multiworld.ServeBatch): CONTROL is a JSON control file
({"width": W, "shutdown": false, "members": [{"name", "seed",
"data_dir", "ckpt_dir", "max_updates"}]}) whose members are admitted
into ghost slots and retired at checkpoint boundaries, each resuming
from its own checkpoint dir when it has one; status in DATA_DIR
/serve.json.  An unreadable control or a width below 1 exits 2, as
does a class the batch refuses.

Supervision: --supervise runs the rest of the command line as a child
(`python -m avida_tpu_torch ARGS... --resume`) under the self-healing
supervisor (service/supervisor.py): heartbeat watchdog, restart with
backoff, the failure taxonomy and its rollbacks.  --fault-plan
"SPEC/SPEC/..." hands boot i the i-th TPU_FAULT spec.  Dispatched before
anything imports torch: the supervisor never loads it.

Fleet: --fleet SPOOL drains a spool of job specs
(`python -m avida_tpu_torch.tools.fleet_tool submit ...`) through up to
--max-jobs concurrent supervised children (service/fleet.py: journal
replay and orphan reaping, admission control, the crash-storm breaker,
the static --worlds coalescer); --serve keeps it running on an empty
spool; --dynamic (or TPU_FLEET_DYNAMIC=1) routes `"batch": true` specs
into warm --serve-worlds class children (service/serve.ServePool).  Also
dispatched before any torch import.

Analysis: bare -a runs ANALYZE_FILE (analyze.cfg, in the config dir)
through the analyze VM (analyze/analyzer.py) instead of an evolution
run; -a CKPT_DIR / --analyze CKPT_DIR runs the checkpoint analytics
(analyze/pipeline.py: census, knockouts and dominant lineage of the
newest valid generation, written under DATA_DIR/analysis/); a CKPT_DIR
that is not a directory exits 2.  The Test CPU runs on --device.

Observability (observability/): --telemetry (-set TPU_TELEMETRY 1) runs
every update phase-fenced and writes DATA_DIR/telemetry.jsonl;
--profile-dir DIR adds a torch.profiler trace of the first
TPU_PROFILE_UPDATES updates into DIR/trace.json; --trace (-set TPU_TRACE
1) arms the flight recorder ({"record": "trace"} lines in
telemetry.jsonl, and the metrics.prom heartbeat).  --status DIR prints
the last heartbeat of the run writing DIR/metrics.prom and exits (0
present, 1 no metrics file, 2 older than --max-age SEC) without
importing torch; on a fleet spool (DIR/fleet.prom or DIR/fleet.jsonl)
it prints the fleet's per-job summary instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from avida_tpu_torch.service import EXIT_AUDIT, EXIT_CKPT, EXIT_SDC


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()


def _worlds_main(args, overrides) -> int:
    """--worlds: the batched run (parallel/multiworld.py)."""
    from avida_tpu_torch.parallel.multiworld import MultiWorld
    spec = args.worlds
    try:
        seeds = [int(s) for s in spec.split(",") if s.strip()]
    except ValueError:
        seeds = None
    try:
        if seeds:
            mw = MultiWorld.from_seeds(seeds, config_dir=args.config_dir,
                                       overrides=overrides,
                                       data_dir=args.data_dir or "data",
                                       device=args.device)
        elif os.path.exists(spec):
            mw = MultiWorld.from_manifest(spec, config_dir=args.config_dir,
                                          overrides=overrides,
                                          device=args.device)
        else:
            print(f"--worlds: {spec!r} is neither a comma seed list nor "
                  f"a worlds.json manifest path", file=sys.stderr)
            return 2
    except (ValueError, NotImplementedError) as e:
        print(f"[avida_tpu_torch] --worlds refused: {e}", file=sys.stderr)
        return 2
    from avida_tpu_torch.utils.audit import StateInvariantError
    from avida_tpu_torch.utils.checkpoint import (CheckpointError,
                                                  CheckpointMismatchError,
                                                  restore_candidates)
    from avida_tpu_torch.utils.integrity import StateDivergenceError
    if args.resume is not None:
        if args.resume:
            print("[avida_tpu_torch] --worlds resumes from each world's "
                  "own checkpoint dir; --resume takes no directory here "
                  "(set TPU_CKPT_DIR / the manifest ckpt_dir instead)",
                  file=sys.stderr)
            return 2
        have = [bool(w._ckpt_base() and restore_candidates(w._ckpt_base()))
                for w in mw.worlds]
        if all(have):
            try:
                mw.resume()
            except CheckpointMismatchError:
                raise
            except CheckpointError as e:
                print(f"[avida_tpu_torch] resume failed: {e}",
                      file=sys.stderr)
                return EXIT_CKPT
            except StateInvariantError as e:
                print(f"[avida_tpu_torch] {e}", file=sys.stderr)
                return EXIT_AUDIT
        elif any(have):
            # no update common to every member: everyone restarts fresh
            # (trajectories are pure functions of the seeds)
            print("[avida_tpu_torch] WARNING: only some worlds have "
                  "checkpoints; no common update exists, so the whole "
                  "batch restarts fresh", file=sys.stderr)
        else:
            print("[avida_tpu_torch] no checkpoints under any world; "
                  "starting fresh", file=sys.stderr)
    start = [w._cum_insts for w in mw.worlds]
    t0 = time.perf_counter()
    try:
        mw.run(max_updates=args.updates)
    except StateDivergenceError as e:
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_SDC
    except StateInvariantError as e:
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_AUDIT
    _sync(mw.device)
    wall = time.perf_counter() - t0
    insts = [w._flush_exec() - s for w, s in zip(mw.worlds, start)]
    from avida_tpu_torch.ops import cycles
    print(json.dumps({"engine": mw.engine,
                      "engine_report": mw.engine_report,
                      "worlds": mw.num_worlds, "names": mw.names,
                      "updates": mw.update,
                      "organisms": [w.num_organisms for w in mw.worlds],
                      "insts": insts, "wall_s": wall,
                      "device": str(mw.device),
                      "kernel_launches": cycles.LAUNCHES,
                      "stacked_launches": cycles.STACKED_LAUNCHES,
                      "preempted": mw.preempted}))
    return 0


def _serve_main(args, overrides) -> int:
    """--serve-worlds: the serving child (parallel/multiworld.ServeBatch).
    The control file names the padded width and the desired membership;
    the fleet's serve pool (service/serve.py) rewrites it to promote and
    demote tenants at checkpoint boundaries.  `--resume` is accepted and
    implicit: admission resumes any member whose checkpoint dir holds
    generations, so one command line both starts and restarts a serve
    child bit for bit."""
    from avida_tpu_torch.parallel.multiworld import ServeBatch
    from avida_tpu_torch.utils.audit import StateInvariantError
    from avida_tpu_torch.utils.integrity import StateDivergenceError

    control = args.serve_worlds
    try:
        with open(control) as f:
            width = int(json.load(f).get("width", 0))
    except (OSError, ValueError, AttributeError) as e:
        print(f"[avida_tpu_torch] --serve-worlds: unreadable control file "
              f"{control!r} ({e})", file=sys.stderr)
        return 2
    if width < 1:
        print(f"[avida_tpu_torch] --serve-worlds: {control!r} needs a "
              f"positive integer 'width'", file=sys.stderr)
        return 2
    data_dir = args.data_dir or os.path.dirname(control) or "data"
    try:
        sb = ServeBatch(width, control, data_dir,
                        config_dir=args.config_dir, overrides=overrides,
                        device=args.device)
    except (ValueError, NotImplementedError) as e:
        print(f"[avida_tpu_torch] --serve-worlds refused: {e}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        sb.serve()
    except StateDivergenceError as e:
        # batch-wide divergence (a GHOST slot changed): every tenant is
        # suspect -- per-tenant corruption never lands here (the serve
        # loop demotes that tenant alone)
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_SDC
    except StateInvariantError as e:
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_AUDIT
    _sync(sb.device)
    if sb.preempted:
        print(f"[avida_tpu_torch] preempted; {sb.num_live} live tenant "
              f"checkpoints saved", file=sys.stderr)
    from avida_tpu_torch.ops import cycles
    from avida_tpu_torch.utils import compilecache
    print(json.dumps({"served": sb.admissions, "retired": sb.retirements,
                      "boundaries": sb.boundaries, "width": sb.width,
                      "wall_s": time.perf_counter() - t0,
                      "device": str(sb.device),
                      "kernel_launches": cycles.LAUNCHES,
                      "stacked_launches": cycles.STACKED_LAUNCHES,
                      "builds": cycles.BUILDS,
                      "cache_hits": compilecache.cache_load_count(),
                      "cache_misses": compilecache.cache_miss_count(),
                      "preempted": sb.preempted}))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--supervise" in argv:
        # dispatched before anything heavy is imported: the supervisor
        # must never load torch (it has to outlive a wedged child runtime)
        from avida_tpu_torch.service.supervisor import supervise_main
        return supervise_main(argv)
    if "--fleet" in argv:
        # the orchestrator, like the supervisor, never loads torch
        from avida_tpu_torch.service.fleet import fleet_main
        return fleet_main(argv)
    p = argparse.ArgumentParser(prog="python -m avida_tpu_torch",
                                description=__doc__.split("\n")[0])
    p.add_argument("-c", "--config-dir", default=None)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-set", dest="overrides", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"))
    p.add_argument("-d", "--data-dir", default=None)
    p.add_argument("-u", "--updates", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.add_argument("--worlds", default=None, metavar="SEEDS|MANIFEST",
                   help="run a batch of worlds (comma seed list or a "
                        "worlds.json manifest)")
    p.add_argument("--resume", nargs="?", const="", default=None,
                   metavar="DIR",
                   help="continue from the newest valid checkpoint under "
                        "DIR (default TPU_CKPT_DIR); empty: start fresh")
    p.add_argument("--serve-worlds", default=None, metavar="CONTROL",
                   help="serve a dynamic-membership batch from a control "
                        "file")
    p.add_argument("-a", "--analyze", nargs="?", const=True, default=None,
                   metavar="CKPT_DIR",
                   help="bare: run ANALYZE_FILE through the analyze VM; "
                        "with CKPT_DIR: checkpoint analytics")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--telemetry", action="store_true",
                   help="phase-fenced updates and telemetry.jsonl "
                        "(-set TPU_TELEMETRY 1)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="with telemetry: a torch.profiler trace of the "
                        "first updates into DIR")
    p.add_argument("--trace", action="store_true",
                   help="the flight recorder (-set TPU_TRACE 1)")
    p.add_argument("--status", default=None, metavar="DIR",
                   help="print the last heartbeat of the run writing to "
                        "DIR and exit")
    p.add_argument("--max-age", type=float, default=None, metavar="SEC",
                   help="with --status: exit 2 when the heartbeat is "
                        "missing or older than SEC seconds")
    args = p.parse_args(argv)

    if args.status is not None:
        # read the metrics.prom / fleet.prom heartbeat only: no World, no
        # torch.  A fleet spool gets the per-job summary
        if os.path.exists(os.path.join(args.status, "fleet.prom")) \
                or os.path.exists(os.path.join(args.status,
                                               "fleet.jsonl")):
            from avida_tpu_torch.service.fleet import fleet_status_main
            return fleet_status_main(args.status, max_age=args.max_age)
        from avida_tpu_torch.observability.exporter import status_main
        return status_main(args.status, max_age=args.max_age)

    overrides = list(args.overrides)
    if args.seed is not None:
        overrides.append(("RANDOM_SEED", str(args.seed)))
    if args.telemetry:
        overrides.append(("TPU_TELEMETRY", "1"))
    if args.trace:
        overrides.append(("TPU_TRACE", "1"))
    if args.profile_dir:
        overrides.append(("TPU_TELEMETRY", "1"))
        overrides.append(("TPU_PROFILE_DIR", args.profile_dir))
    if isinstance(args.analyze, str):
        # checkpoint analytics over an archived run; argparse also takes
        # a bundled flag such as -av as analyze='v', so a token that is
        # not a directory fails loudly instead of being rerouted
        if not os.path.isdir(args.analyze):
            print(f"[avida_tpu_torch] --analyze: {args.analyze!r} is not a "
                  f"checkpoint directory (bare -a runs the analyze VM; "
                  f"-a/--analyze CKPT_DIR runs checkpoint analytics -- "
                  f"note bundled short flags like -av no longer parse)",
                  file=sys.stderr)
            return 2
        from avida_tpu_torch.analyze.pipeline import cli_main
        return cli_main(args.analyze, config_dir=args.config_dir,
                        overrides=overrides, data_dir=args.data_dir,
                        verbose=args.verbose, device=args.device)
    if args.serve_worlds is not None:
        return _serve_main(args, overrides)
    if args.worlds is not None:
        return _worlds_main(args, overrides)

    from avida_tpu_torch.utils.audit import StateInvariantError
    from avida_tpu_torch.utils.checkpoint import (CheckpointError,
                                                  CheckpointMismatchError,
                                                  restore_candidates)
    from avida_tpu_torch.utils.integrity import StateDivergenceError
    from avida_tpu_torch.world import World
    w = World(config_dir=args.config_dir, overrides=overrides,
              data_dir=args.data_dir, device=args.device)
    if args.analyze:
        from avida_tpu_torch.analyze.analyzer import Analyzer
        az = Analyzer(w.params, w.instset, data_dir=w.data_dir,
                      verbose=args.verbose, device=w.device)
        az.run_file(os.path.join(args.config_dir, w.cfg.ANALYZE_FILE)
                    if args.config_dir else w.cfg.ANALYZE_FILE)
        return 0
    if args.resume is not None:
        # a first boot with an empty checkpoint directory starts fresh;
        # generations that exist but all fail verification exit 66
        base = args.resume or w._ckpt_base()
        if base and not restore_candidates(base):
            print(f"[avida_tpu_torch] no checkpoint under {base}; starting "
                  f"fresh", file=sys.stderr)
        else:
            try:
                w.resume(args.resume or None)
            except CheckpointMismatchError:
                raise
            except CheckpointError as e:
                print(f"[avida_tpu_torch] resume failed: {e}",
                      file=sys.stderr)
                return EXIT_CKPT
            except StateInvariantError as e:
                print(f"[avida_tpu_torch] {e}", file=sys.stderr)
                return EXIT_AUDIT
    t0 = time.perf_counter()
    try:
        insts = w.run(max_updates=args.updates)
    except StateDivergenceError as e:
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_SDC
    except StateInvariantError as e:
        print(f"[avida_tpu_torch] {e}", file=sys.stderr)
        return EXIT_AUDIT
    _sync(w.device)
    wall = time.perf_counter() - t0
    if w.preempted:
        print(f"[avida_tpu_torch] preempted at update {w.update}; "
              f"checkpoint saved", file=sys.stderr)
    from avida_tpu_torch.ops import cycles
    print(json.dumps({"updates": w.update, "organisms": w.num_organisms,
                      "insts": insts, "wall_s": wall,
                      "device": str(w.device),
                      "engine": w.engine_report(),
                      "kernel_launches": cycles.LAUNCHES,
                      "preempted": w.preempted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
