"""Command line: `python -m avida_tpu_torch [-u N] [-s SEED] [-d DIR]
[-c CONFIG_DIR] [-set NAME VALUE ...] [--device cuda|cpu]`.

Runs one world and writes its .dat files, with the reference's defaults
(systematics on: the per-update engine; -set TPU_SYSTEMATICS 0 takes the
packed-resident engine).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


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
    args = p.parse_args(argv)

    from avida_tpu_torch.world import World
    overrides = list(args.overrides)
    if args.seed is not None:
        overrides.append(("RANDOM_SEED", str(args.seed)))
    w = World(config_dir=args.config_dir, overrides=overrides,
              data_dir=args.data_dir, device=args.device)
    t0 = time.perf_counter()
    insts = w.run(max_updates=args.updates)
    if w.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"updates": w.update, "organisms": w.num_organisms,
                      "insts": insts, "wall_s": wall,
                      "device": str(w.device),
                      "engine": w.engine_report()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
