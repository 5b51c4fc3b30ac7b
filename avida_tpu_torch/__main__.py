"""Command line: `python -m avida_tpu_torch [-u N] [-s SEED] [-d DIR]
[-c CONFIG_DIR] [-set NAME VALUE ...] [--device cuda|cpu]
[--worlds SEEDS|MANIFEST]`.

Runs one world and writes its .dat files, with the reference's defaults
(systematics on: the per-update engine; -set TPU_SYSTEMATICS 0 takes the
packed-resident engine; -set TPU_USE_PALLAS 2 the micro-step engine).
--worlds runs a batch of static-equal worlds with the update's cycles run
once for the whole batch
(parallel/multiworld.py): SEEDS is a comma list ("7,8,9"; world k writes
to DATA_DIR/w00k), MANIFEST a worlds.json path ([{"name", "seed",
"data_dir"}]).  A batch the configuration refuses exits 2 with the
reason.  --resume and --serve-worlds are not ported and exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


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
    start = [w._cum_insts for w in mw.worlds]
    t0 = time.perf_counter()
    mw.run(max_updates=args.updates)
    _sync(mw.device)
    wall = time.perf_counter() - t0
    insts = [w._flush_exec() - s for w, s in zip(mw.worlds, start)]
    print(json.dumps({"engine": mw.engine,
                      "engine_report": mw.engine_report,
                      "worlds": mw.num_worlds, "names": mw.names,
                      "updates": mw.update,
                      "organisms": [w.num_organisms for w in mw.worlds],
                      "insts": insts, "wall_s": wall,
                      "device": str(mw.device)}))
    return 0


def main(argv=None) -> int:
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
                   metavar="DIR", help="not ported (checkpoints)")
    p.add_argument("--serve-worlds", default=None, metavar="CONTROL",
                   help="not ported (the serving batch)")
    args = p.parse_args(argv)

    if args.resume is not None:
        print("[avida_tpu_torch] --resume: checkpoints are not ported to "
              "avida_tpu_torch yet (ROADMAP.md Queue 1 item 11)",
              file=sys.stderr)
        return 2
    if args.serve_worlds is not None:
        print("[avida_tpu_torch] --serve-worlds: the serving batch "
              "(ServeBatch) is not ported to avida_tpu_torch yet "
              "(ROADMAP.md Queue 1 item 16)", file=sys.stderr)
        return 2
    overrides = list(args.overrides)
    if args.seed is not None:
        overrides.append(("RANDOM_SEED", str(args.seed)))
    if args.worlds is not None:
        return _worlds_main(args, overrides)

    from avida_tpu_torch.world import World
    w = World(config_dir=args.config_dir, overrides=overrides,
              data_dir=args.data_dir, device=args.device)
    t0 = time.perf_counter()
    insts = w.run(max_updates=args.updates)
    _sync(w.device)
    wall = time.perf_counter() - t0
    print(json.dumps({"updates": w.update, "organisms": w.num_organisms,
                      "insts": insts, "wall_s": wall,
                      "device": str(w.device),
                      "engine": w.engine_report()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
