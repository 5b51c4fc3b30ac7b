"""Checkpoint-native run analytics CLI (analyze/pipeline.py).
Counterpart of the reference's scripts/analyze_tool.py.

Usage:
    python -m avida_tpu_torch.tools.analyze_tool CKPT_DIR [options]

    -c DIR            config directory of the archived run (avida.cfg /
                      environment / instruction set); built-in defaults
                      when absent.  TPU_MAX_MEMORY is defaulted from the
                      checkpoint itself so the Test CPU's genome buffer
                      matches the archived state.
    -d DIR            data dir for the outputs; defaults to the sibling
                      `data/` of CKPT_DIR when it exists (the fleet
                      fault-domain layout SPOOL/<job>/{data,ck}), else
                      the configured DATA_DIR.
    -set NAME VALUE   config override (repeatable)
    --census-only     skip the knockout sweeps (census + lineage only)
    --knockout-top N  genotypes to knockout-sweep (default 4: dominant +
                      most-abundant threshold genotypes)
    --seed N          sandbox PRNG seed (default 0)
    --device DEV      cuda (default) or cpu (the plain PyTorch versions)
    -v                print output paths

The standalone face of `python -m avida_tpu_torch --analyze CKPT_DIR`:
loads the newest CRC-valid generation (falling back past corrupt ones
exactly like --resume), reconstructs the population + systematics
tables, and runs the batched phenotype census, knockout attribution and
dominant-lineage replay offline.  Results: census.dat / knockout.dat /
lineage.dat under DATA_DIR/analysis/, {"record":"analytics"} lines in
DATA_DIR/analysis/analytics.jsonl, and DATA_DIR/analytics.prom for
`--status` / Prometheus.  Exit codes: 0 ok, 66 no valid checkpoint
(matching --resume's classified exit), 2 config mismatch.  It loads
torch through the pipeline.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("-c", "--config-dir", default=None)
    p.add_argument("-d", "--data-dir", default=None)
    p.add_argument("-set", dest="overrides", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"))
    p.add_argument("--census-only", action="store_true")
    p.add_argument("--knockout-top", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from avida_tpu_torch.analyze.pipeline import cli_main
    return cli_main(args.ckpt_dir, config_dir=args.config_dir,
                    overrides=list(map(tuple, args.overrides)),
                    data_dir=args.data_dir, verbose=args.verbose,
                    knockout_top=args.knockout_top,
                    census_only=args.census_only, seed=args.seed,
                    device=args.device)


if __name__ == "__main__":
    sys.exit(main())
