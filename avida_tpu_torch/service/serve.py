"""Batchability classes of job specs: the static `--worlds` coalescer's key.

Counterpart of the first part of avida_tpu/service/serve.py (host-only:
nothing here imports torch).  The fleet orchestrator (service/fleet.py)
coalesces queued `"batch": true` specs of one class into ONE supervised
`--worlds` child.  `static_signature` resolves a spec's argv the way the
child CLI would (config files loaded, `-set` overrides applied through
config/schema.py, config-dir file contents fingerprinted) and hashes the
RESOLVED static configuration with the non-static knobs (seed, output
and checkpoint dirs, verbosity, checkpoint cadence) stripped.  Two specs
that differ only in spelling -- output dirs, `-s` position vs `-set
RANDOM_SEED`, override order, defaults spelled out vs omitted -- land in
one class; the digests equal the reference's string for string.

`SpecArgv` is the one spelling of spec-argv analysis (seed extraction
for the worlds manifest, dir stripping for fault-domain safety, `-u`
extraction), and `member_argv` the argv a `--worlds` child is launched
with.

The streaming serve layer of the reference's module -- `width_class`,
`batch_ineligible_reason`, `ServeClass` and `ServePool`, the warm
`--serve-worlds` children behind `--fleet --dynamic` -- is ROADMAP item
16c and not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os

# config vars that do NOT change the compiled update program or the
# evolved trajectory of a tenant (seeds and output/checkpoint routing,
# cadence knobs the serve child overrides class-wide anyway): stripped
# before hashing so they cannot split a batchability class
NONSTATIC_VARS = frozenset((
    "RANDOM_SEED", "DATA_DIR", "VERBOSITY",
    "TPU_CKPT_DIR", "TPU_CKPT_EVERY", "TPU_CKPT_KEEP", "TPU_CKPT_FINAL",
    "TPU_CKPT_AUDIT", "TPU_METRICS", "TPU_SERVE_IDLE_SEC",
    "TPU_SERVE_POLL_SEC", "TPU_SERVE_WARM",
    # the persistent program cache changes neither the update program's
    # semantics nor the trajectory (the reference's
    # utils/compilecache.py; ROADMAP item 16d in the port) -- cache
    # knobs must not split a batchability class
    "TPU_COMPILE_CACHE", "TPU_COMPILE_CACHE_DIR",
    # the integrity plane (digests + sampled shadow replay) is host-side
    # batch-level instrumentation: trajectories are bit-identical with
    # it on or off, so its knobs must not split a class either
    "TPU_STATE_DIGEST", "TPU_SCRUB_EVERY",
    # telemetry history rings (observability/history.py) are host-side
    # instrumentation too -- sampling cadence cannot split a class
    "TPU_METRICS_HIST", "TPU_METRICS_HIST_EVERY",
    "TPU_METRICS_HIST_MAX_BYTES",
    # the performance attribution plane (observability/profiler.py)
    # probes device-owned state COPIES only -- trajectories are
    # bit-identical with it on or off, so its knobs cannot split a
    # batchability class either
    "TPU_PROFILE", "TPU_PROFILE_EVERY", "TPU_PROFILE_TRACE",
))
# Reviewed and deliberately NOT listed: TPU_PACKED_CHUNK,
# TPU_PACKED_FUSED, TPU_PACKED_BITS.  They are program-affecting
# STATICS -- each selects a different update engine body / resident
# plane layout -- so a batch must not mix values.  They stay in the
# signature and split batchability classes, exactly like
# TPU_USE_PALLAS.

# spec env vars that are per-job operational knobs, not program inputs
_NONSTATIC_ENV = frozenset((
    "TPU_WATCHDOG_SEC", "TPU_SUPERVISE_POLL_SEC", "TPU_SUPERVISE_GRACE_SEC",
    "TPU_SUPERVISE_MAX_RETRIES", "TPU_SUPERVISE_BACKOFF_BASE",
    "TPU_SUPERVISE_BACKOFF_CAP", "TPU_SUPERVISE_HEALTHY_SEC",
    "TPU_SUPERVISE_SEED", "TPU_PROGRESS_SEC",
    "TPU_COMPILE_CACHE", "TPU_COMPILE_CACHE_DIR",
    "TPU_METRICS_HIST", "TPU_METRICS_HIST_EVERY",
    "TPU_METRICS_HIST_MAX_BYTES", "TPU_ALERT_EVAL_SEC",
    "TPU_PROFILE", "TPU_PROFILE_EVERY", "TPU_PROFILE_TRACE",
))


class SpecArgv:
    """One parsed child argv: the pieces the serving layer routes on.
    THE one spelling of spec-argv analysis -- seed extraction for the
    worlds manifest, dir stripping for fault-domain safety, `-u`
    extraction for per-member budgets -- used by the static coalescer
    (fleet._form_batches / _start_batch)."""

    def __init__(self, argv):
        self.config_dir = None
        self.sets = []                  # (-set NAME VALUE) pairs, in order
        self.residual = []              # tokens the serving layer keeps
        self.seed = None                # -s / --seed (beats -set RANDOM_SEED)
        self.set_seed = None
        self.updates = None             # -u / --updates
        self.data_dir = None
        argv = list(argv or ())
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in ("-s", "--seed") and i + 1 < len(argv):
                self.seed = argv[i + 1]
                i += 2
            elif a in ("-d", "--data-dir") and i + 1 < len(argv):
                self.data_dir = argv[i + 1]
                i += 2
            elif a in ("-u", "--updates") and i + 1 < len(argv):
                self.updates = argv[i + 1]
                i += 2
            elif a in ("-c", "--config-dir") and i + 1 < len(argv):
                self.config_dir = argv[i + 1]
                i += 2
            elif a == "-set" and i + 2 < len(argv):
                self.sets.append((argv[i + 1], argv[i + 2]))
                i += 3
            else:
                self.residual.append(a)
                i += 1

    @property
    def effective_seed(self):
        """The seed the child would use: `-s` beats `-set RANDOM_SEED`
        regardless of argv position (the solo CLI appends -s AFTER
        every -set override; last one wins in the config)."""
        raw = self.seed
        if raw is None:
            for n, v in self.sets:
                if n == "RANDOM_SEED":
                    raw = v
        try:
            return int(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None

    @property
    def max_updates(self):
        try:
            return int(self.updates) if self.updates is not None else None
        except ValueError:
            return None


def member_argv(spec) -> list:
    """A spec's argv with the per-member routing stripped (seed, data
    dir, checkpoint dir) -- what a `--worlds` / `--serve-worlds` class
    child is launched with (the worlds manifest / control file carries
    the per-member values).  `-u` is KEPT: the static coalescer runs
    one shared budget; the serve pool strips it separately via
    SpecArgv.max_updates into per-member budgets."""
    argv = list(spec.get("argv") or ())
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-s", "--seed", "-d", "--data-dir") and i + 1 < len(argv):
            i += 2
            continue
        if a == "-set" and i + 2 < len(argv) \
                and argv[i + 1] in ("RANDOM_SEED", "TPU_CKPT_DIR"):
            i += 3
            continue
        out.append(a)
        i += 1
    return out


def _config_fingerprint(config_dir: str) -> object:
    """Content hash of every regular file in a spec's config dir: two
    specs naming different config dirs with IDENTICAL contents resolve
    to one class; editing any config file splits it.  Config dirs are a
    handful of small text files; unreadable entries hash by name."""
    if not config_dir:
        return None
    try:
        names = sorted(os.listdir(config_dir))
    except OSError:
        return f"unreadable:{os.path.realpath(config_dir)}"
    h = hashlib.sha1()
    for n in names:
        p = os.path.join(config_dir, n)
        if not os.path.isfile(p):
            continue
        h.update(n.encode())
        try:
            with open(p, "rb") as f:
                h.update(hashlib.sha1(f.read()).digest())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def static_signature(spec, with_updates: bool = True) -> str:
    """The canonical batchability-class key for one job spec: a digest
    of the RESOLVED static configuration.

    Resolution mirrors the child CLI: load `avida.cfg` from the spec's
    config dir (builtin defaults when absent), apply its `-set`
    overrides in order, then drop NONSTATIC_VARS (seed, dirs, cadence
    knobs).  The digest also covers the config-dir file contents (the
    instruction set / environment / events / ancestor files the
    resolved config names all live there), the residual argv tokens the
    parser didn't interpret (unknown flags must not falsely coalesce),
    and the spec's env minus per-job supervisor knobs.  `with_updates`
    keeps `-u` in the key (the static `--worlds` coalescer shares one
    budget); the serve pool passes False and carries per-member budgets
    in the control file.

    Falls back to a literal-argv key when resolution fails (unreadable
    config): degrading to byte-equality of the argv is always safe."""
    from avida_tpu_torch.config.schema import AvidaConfig, load_avida_cfg
    pa = SpecArgv(spec.get("argv"))
    env = tuple(sorted((k, v) for k, v in (spec.get("env") or {}).items()
                       if k not in _NONSTATIC_ENV))
    try:
        import warnings
        if pa.config_dir:
            cfg_path = os.path.join(pa.config_dir, "avida.cfg")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if os.path.exists(cfg_path):
                    cfg = load_avida_cfg(cfg_path, pa.sets)
                else:
                    cfg = AvidaConfig()
                    for n, v in pa.sets:
                        cfg.set(n, v)
        else:
            cfg = AvidaConfig()
            for n, v in pa.sets:
                cfg.set(n, v)
        static = {n: getattr(cfg, n) for n in sorted(cfg.field_names())
                  if n not in NONSTATIC_VARS}
        static["extras"] = {k: v for k, v in sorted(cfg.extras.items())
                            if k not in NONSTATIC_VARS}
        body = {
            "static": static,
            "config_files": _config_fingerprint(pa.config_dir),
            "residual": list(pa.residual),
            "env": env,
        }
        if with_updates:
            body["updates"] = pa.updates
        text = json.dumps(body, sort_keys=True, default=str)
        return "sig:" + hashlib.sha1(text.encode()).hexdigest()
    except Exception:
        key = (tuple(member_argv(spec)), env,
               pa.updates if with_updates else None)
        return "raw:" + hashlib.sha1(repr(key).encode()).hexdigest()
