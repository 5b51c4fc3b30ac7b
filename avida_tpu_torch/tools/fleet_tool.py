"""Fleet spool CLI: submit / list / cancel / requeue jobs (service/fleet.py).

Counterpart of the reference's scripts/fleet_tool.py, over the same
spool format (a spool either package's orchestrator drains).  Usage:

    python -m avida_tpu_torch.tools.fleet_tool submit SPOOL NAME [--batch]
            [--tenant T] [--shard N] [--backpressure MAX]
            [--fault-plan S/S...] [--env K=V]... -- CHILD_ARGV...
    python -m avida_tpu_torch.tools.fleet_tool list SPOOL
    python -m avida_tpu_torch.tools.fleet_tool cancel SPOOL NAME
    python -m avida_tpu_torch.tools.fleet_tool requeue SPOOL NAME
    python -m avida_tpu_torch.tools.fleet_tool gen-trace OUT --seed N
            [--jobs N] [--classes N] [--cancel FRAC] [--span SEC]
            [--updates U] [--tenants N]

`submit` writes `SPOOL/NAME.json` atomically (tmp + rename), so a live
orchestrator can never pick up a half-written spec.  Everything after
`--` is the child run's command line exactly as `--supervise` takes it,
MINUS `-d`/`-set TPU_CKPT_DIR` (the fleet assigns the job's fault
domain itself).  `cancel`/`requeue` drop marker files the orchestrator
consumes on its next poll -- they work while it runs; a `requeue` of a
failed job left over from a dead orchestrator is honored by the next
one's startup scan.

`list` needs no orchestrator at all: it reconstructs job states from
the fleet journal plus the spool contents, so it answers "what happened
to my sweep?" after everything has exited.

`--batch` marks the spec for coalescing: the orchestrator runs queued
--batch specs of one batchability class -- the CANONICAL
resolved-static-config signature (service/serve.py), so specs may
differ in dirs, seed spelling or override order -- as ONE supervised
`--worlds` child.  Each world keeps its own job dir, .dat output and
solo-compatible checkpoints; on a static mismatch (or no peer, or a
fault plan) the spec falls back to process-per-job with the reason
journaled.  The argv must name its seed explicitly (`-s N`).

Admission flags: `--tenant T` labels the spec for the per-tenant quota
(TPU_FLEET_TENANT_MAX); `--shard N` spreads specs over `shard-<k>/`
subdirs the orchestrator scans round-robin (one per poll tick --
thousands of queued specs never stall a tick); and `--backpressure MAX`
refuses the submit (exit 3) while MAX specs already sit queued on disk
-- the producer-side half of TPU_FLEET_QUEUE_MAX.

`gen-trace` writes a deterministic arrival/cancel churn trace
(utils/churntrace.py grammar, seeded like TPU_FAULT specs).

Nothing here imports torch.
"""

from __future__ import annotations

import json
import os
import sys


class QueueFullError(RuntimeError):
    """--backpressure MAX refused the submit (the queue is full)."""


def _queued_count(spool: str) -> int:
    """Specs waiting on disk: spool root + every shard-* subdir."""
    n = 0
    try:
        entries = os.listdir(spool)
    except OSError:
        return 0
    for fn in entries:
        p = os.path.join(spool, fn)
        if fn.startswith("shard-") and os.path.isdir(p):
            n += sum(1 for s in os.listdir(p)
                     if s.endswith(".json") and not s.startswith(".")
                     and not s.endswith(".cancelled.json"))
        elif fn.endswith(".json") and not fn.startswith(".") \
                and not fn.endswith(".cancelled.json"):
            n += 1
    return n


def _spec_exists(spool: str, name: str) -> bool:
    """A queued spec anywhere in the spool: the root OR any shard-*
    subdir.  The duplicate check must span all of them -- the same name
    submitted with different --shard values hashes to different dirs,
    and the orchestrator would ingest one and silently strand the
    other (inflating --backpressure counts forever)."""
    if os.path.exists(os.path.join(spool, name + ".json")):
        return True
    try:
        entries = os.listdir(spool)
    except OSError:
        return False
    return any(fn.startswith("shard-")
               and os.path.isfile(os.path.join(spool, fn,
                                               name + ".json"))
               for fn in entries)


def submit(spool: str, name: str, argv: list, fault_plan=(),
           env=None, batch: bool = False, tenant: str = "",
           shard: int | None = None,
           backpressure: int = 0) -> str:
    """Write one job spec atomically; returns its path.  Validates with
    the orchestrator's own schema check so a typo is caught here, not
    quarantined later.  `shard=N` hashes the job into `shard-<k>/`
    (k = hash(name) % N); `backpressure=MAX` raises QueueFullError
    while MAX specs already wait on disk."""
    import zlib

    from avida_tpu_torch.service.fleet import (legal_name,
                                               spec_seed_and_batch_key,
                                               validate_spec)
    if not legal_name(name):
        raise ValueError(f"illegal job name {name!r}")
    spec = {"argv": list(argv)}
    if fault_plan:
        spec["fault_plan"] = list(fault_plan)
    if env:
        spec["env"] = dict(env)
    if tenant:
        spec["tenant"] = str(tenant)
    if batch:
        spec["batch"] = True
        if fault_plan:
            raise ValueError("--batch and --fault-plan are exclusive "
                             "(fault injection is per-process)")
        if spec_seed_and_batch_key(spec)[0] is None:
            raise ValueError("--batch needs an explicit seed in the "
                             "child argv (-s N) to key the world")
    validate_spec(spec)
    if backpressure and _queued_count(spool) >= int(backpressure):
        raise QueueFullError(
            f"{spool!r} already holds >= {backpressure} queued specs "
            f"(backpressure); resubmit once the fleet drains")
    dest = spool
    if shard:
        k = zlib.crc32(name.encode()) % int(shard)
        dest = os.path.join(spool, f"shard-{k:02d}")
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, name + ".json")
    if _spec_exists(spool, name) \
            or os.path.isdir(os.path.join(spool, name)):
        raise ValueError(f"job {name!r} already exists in {spool!r}")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def list_jobs(spool: str) -> list:
    """(name, state) pairs from the journal + spool scan (the same
    merge the --status fleet view renders)."""
    from avida_tpu_torch.service.fleet import spool_job_states
    return sorted(spool_job_states(spool).items())


def _marker(spool: str, name: str, kind: str) -> str:
    path = os.path.join(spool, f"{name}.{kind}")
    with open(path, "w"):
        pass
    return path


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    cmd, spool = argv[0], argv[1]
    rest = argv[2:]
    if cmd == "submit":
        if not rest or "--" not in rest or rest[0].startswith("-"):
            print("submit needs: SPOOL NAME [flags] -- CHILD_ARGV...")
            return 2
        name = rest[0]
        sep = rest.index("--")
        flags, child = rest[1:sep], rest[sep + 1:]
        fault_plan, env, batch = (), {}, False
        tenant, shard, backpressure = "", None, 0
        i = 0
        while i < len(flags):
            if flags[i] == "--fault-plan" and i + 1 < len(flags):
                fault_plan = tuple(flags[i + 1].split("/"))
                i += 2
            elif flags[i] == "--env" and i + 1 < len(flags) \
                    and "=" in flags[i + 1]:
                k, _, v = flags[i + 1].partition("=")
                env[k] = v
                i += 2
            elif flags[i] == "--batch":
                batch = True
                i += 1
            elif flags[i] == "--tenant" and i + 1 < len(flags):
                tenant = flags[i + 1]
                i += 2
            elif flags[i] == "--shard" and i + 1 < len(flags) \
                    and flags[i + 1].isdigit():
                shard = int(flags[i + 1])
                i += 2
            elif flags[i] == "--backpressure" and i + 1 < len(flags) \
                    and flags[i + 1].isdigit():
                backpressure = int(flags[i + 1])
                i += 2
            else:
                print(f"unknown submit flag {flags[i]!r}")
                return 2
        try:
            path = submit(spool, name, child, fault_plan=fault_plan,
                          env=env, batch=batch, tenant=tenant,
                          shard=shard, backpressure=backpressure)
        except QueueFullError as e:
            print(f"submit held: {e}")
            return 3
        except ValueError as e:
            print(f"submit rejected: {e}")
            return 2
        print(f"submitted {path}")
        return 0
    if cmd == "gen-trace":
        # `spool` is the OUT path for this subcommand
        from avida_tpu_torch.utils import churntrace
        opts = {"seed": None, "jobs": 12, "classes": 1, "cancel": 0.2,
                "span": 30.0, "updates": 40, "tenants": 1}
        i = 0
        while i < len(rest):
            key = rest[i].lstrip("-")
            if rest[i].startswith("--") and key in opts \
                    and i + 1 < len(rest):
                opts[key] = float(rest[i + 1]) if key == "cancel" \
                    else (float(rest[i + 1]) if key == "span"
                          else int(rest[i + 1]))
                i += 2
            else:
                print(f"unknown gen-trace flag {rest[i]!r}")
                return 2
        if opts["seed"] is None:
            print("gen-trace needs --seed N (determinism is the point)")
            return 2
        events = churntrace.generate(
            opts["seed"], jobs=opts["jobs"], classes=opts["classes"],
            cancel_frac=opts["cancel"], span=opts["span"],
            updates=opts["updates"], tenants=opts["tenants"])
        text = churntrace.format_trace(
            events, seed=opts["seed"],
            note=(f"jobs={opts['jobs']} classes={opts['classes']} "
                  f"cancel={opts['cancel']} span={opts['span']} "
                  f"updates={opts['updates']} tenants={opts['tenants']}"))
        with open(spool, "w") as f:
            f.write(text)
        print(f"wrote {len(events)} events to {spool}")
        return 0
    if cmd == "list":
        jobs = list_jobs(spool)
        if not jobs:
            print(f"no jobs in {spool!r}")
            return 0
        for name, state in jobs:
            print(f"{name:<24} {state}")
        return 0
    if cmd in ("cancel", "requeue"):
        if not rest:
            print(f"{cmd} needs: SPOOL NAME")
            return 2
        name = rest[0]
        known = dict(list_jobs(spool))
        if name not in known:
            print(f"no such job {name!r} in {spool!r}")
            return 2
        path = _marker(spool, name, cmd)
        print(f"{cmd} marker written: {path} (consumed by the "
              f"orchestrator's next poll)")
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
