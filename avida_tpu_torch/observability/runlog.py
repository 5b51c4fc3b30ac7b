"""Structured run logs: telemetry.jsonl emitter + the World-facing recorder.

Counterpart of avida_tpu/observability/runlog.py.  One JSON object per
line:

  {"record": "meta", ...}     -- once, at the first telemetry update: run
                                 metadata (seed, world geometry, device,
                                 cycle route, instruction names)
  {"record": "update", ...}   -- per update: phase wall-time breakdown
                                 (ms), counter snapshot (births, deaths,
                                 executed instructions, per-task triggers,
                                 budget-tail utilization, dispatch mix)
  {"record": "trace", ...}    -- the flight recorder's drains (tracer.py)
  {"record": "event", ...}    -- out-of-band run events (emit_event)

Counter semantics reconcile EXACTLY with the .dat outputs of the same run
(tests/test_torch_telemetry.py):

  births        == count.dat / average.dat births for this update
  executed      == count.dat "insts executed this update"
  task_triggers == the tasks_exe.dat row for this update

`TelemetryRecorder` owns the Timeline, the StagedUpdate runner and the
writer; World delegates run_update to it when TPU_TELEMETRY is on.  The
meta record's "interpret_path" keeps the reference's words: "pallas"
names the kernel route (the CUDA kernel on the card), "xla_while_loop"
the micro-step engine; "platform", "device" and "num_devices" name the
card (torch.cuda.get_device_name) or the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from avida_tpu_torch.observability.counters import (budget_block,
                                                    budget_tail,
                                                    update_counters)
from avida_tpu_torch.observability.records import (  # noqa: F401
    append_record, read_records)
from avida_tpu_torch.observability.staged import StagedUpdate
from avida_tpu_torch.observability.timeline import Timeline
from avida_tpu_torch.utils import prng


class TelemetryWriter:
    """Append-only JSONL file, flushed per record."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, mode)

    def write(self, record: dict):
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def trim_update_records(path: str, max_update: int):
    """Resume continuity for telemetry.jsonl: drop per-update records
    at or past the restored update (a crash that outran the last
    auto-save leaves newer records on disk; re-run updates would
    otherwise appear twice).  STRICT cutoff: update records are labeled
    with the index of the update being executed, so a checkpoint at
    update N owns records 0..N-1 and the resumed run re-emits from N.
    Flight-recorder {"record": "trace"} lines carry the same per-update
    labeling and trim identically.  Analytics census records
    ({"record": "analytics"}, analyze/pipeline.py) trim on a STRICT
    cutoff instead (update > max_update): a census is labeled with the
    checkpoint boundary it DESCRIBES, so the census at the restored
    update is valid evidence of exactly the state the resume restores
    (and is never re-emitted until the next boundary), while censuses
    past it describe a rolled-back timeline and must not survive as
    evidence of what the replayed run evolved.  Meta/event records
    carry no update number and are kept.  Atomic rewrite; missing file
    is a no-op."""
    if not os.path.exists(path):
        return
    kept = []
    dropped = 0
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                dropped += 1          # torn tail line from the crash
                continue
            kind = rec.get("record")
            u = int(rec.get("update", -1))
            if (kind in ("update", "trace") and u >= max_update) \
                    or (kind == "analytics" and u > max_update):
                dropped += 1
                continue
            kept.append(line)
    if dropped:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)


def emit_event(world, event: str, **fields):
    """Structured out-of-band run event ({"record": "event", ...}).

    The checkpoint/resume machinery, the integrity plane and fault
    injection report through this: the record lands in telemetry.jsonl
    when the run has an open telemetry writer, and is always echoed to
    stderr so headless runs still surface warnings.  Never raises -- a
    logging failure must not take down the save/restore path it is
    reporting on."""
    rec = {"record": "event", "event": event, "time": time.time(), **fields}
    try:
        tel = getattr(world, "telemetry", None)
        if tel is not None and tel._writer is not None:
            tel._writer.write(rec)
    except Exception:
        pass
    try:
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[avida_tpu_torch] {event}" + (f": {detail}" if detail else ""),
              file=sys.stderr)
    except Exception:
        pass


class TelemetryRecorder:
    """Drives phase-fenced updates for a World and emits telemetry.jsonl.

    Lazy: nothing is built and no file is opened until the first update
    runs under telemetry, so constructing a World with TPU_TELEMETRY=0
    (or never running one with it on) writes nothing."""

    def __init__(self, world, profile_dir: str | None = None,
                 profile_updates: int = 3):
        self.world = world
        self.timeline = Timeline(world.device)
        self.profile_dir = profile_dir
        self.profile_updates = max(int(profile_updates), 0)
        self._staged: StagedUpdate | None = None
        self._writer: TelemetryWriter | None = None
        self._block = None
        self._task_prev = None
        self._updates_run = 0
        self._pending = None        # device handles awaiting emit

    # ---- lazy setup ----

    def _ensure(self):
        if self._staged is None:
            w = self.world
            self._staged = StagedUpdate(w.params, w.neighbors)
            self._block = budget_block(w.params, w.params.num_cells)
        if self._writer is None:
            w = self.world
            # append on reopen (a World.run() close followed by more
            # updates must not truncate earlier records)
            reopen = getattr(self, "_log_opened", False)
            self._writer = TelemetryWriter(
                os.path.join(w.data_dir, "telemetry.jsonl"),
                mode=("a" if reopen else "w"))
            self._log_opened = True
            if reopen:
                return
            dev = w.device
            cuda = dev.type == "cuda"
            self._writer.write({
                "record": "meta",
                "time": time.time(),
                "seed": int(w.cfg.RANDOM_SEED),
                "world": [w.params.world_x, w.params.world_y],
                "num_cells": int(w.params.num_cells),
                "max_memory": int(w.params.max_memory),
                "hw_type": int(w.params.hw_type),
                "max_steps_per_update": int(w.params.max_steps_per_update),
                "platform": "gpu" if cuda else "cpu",
                "device": (torch.cuda.get_device_name(dev) if cuda
                           else "cpu"),
                "num_devices": torch.cuda.device_count() if cuda else 1,
                "interpret_path": ("pallas" if self._staged.kernel
                                   else "xla_while_loop"),
                "budget_block": int(self._block),
                "dispatch_mix": self._staged.collect_dispatch,
                "inst_names": list(w.instset.inst_names),
                "task_names": list(w.environment.task_names()),
            })

    # ---- the update path (called from World.run_update) ----

    def update(self, world):
        """Run world's next update phase-fenced.  Returns the executed
        count (device scalar) and leaves the record pending until
        emit()."""
        self._ensure()
        if self._task_prev is None:
            # tasks-trigger diff baseline = totals BEFORE the first
            # telemetry update (nonzero for restored/mid-run states)
            self._task_prev = world.state.task_exe_total.sum(
                dim=0).cpu().numpy().astype(np.int64)
        if self.profile_dir and self._updates_run == 0 \
                and self.profile_updates > 0:
            self.timeline.start_trace(self.profile_dir)

        tl = self.timeline
        u = world.update
        key = tl.run("schedule", prng.fold_in, world._run_key, u)
        st, executed, dispatch, granted, alive_before = self._staged.run(
            world.state, key, u, tl)
        world.state = st

        counters = tl.run("counters", update_counters, world.params, st,
                          alive_before, u)
        tail = tl.run("counters", budget_tail, granted, self._block)

        # host bookkeeping, mirroring ops/update.update_scan's per-update
        # outputs for the chunk-of-1 case (avida time, generation
        # triggers, birth/death device scalars)
        from avida_tpu_torch.ops.update import light_stats, update_stats_from
        vals = tl.run("counters", light_stats, world.params, st, u)
        with tl.phase("counters"):
            births, _, dt, ave_gen, n_alive = update_stats_from(
                vals, alive_before)
            world._avida_time = world._avida_time + dt
            world._last_ave_gen = ave_gen
            world._deaths_this = counters["deaths"]
            world._prev_alive = n_alive
            world._total_births = world._total_births + births

        self._pending = (u, executed, dispatch, counters, tail)
        self._updates_run += 1
        if self.timeline._tracing and self._updates_run >= self.profile_updates:
            self.timeline.stop_trace()
        return executed

    def emit(self, world):
        """Write the pending update record (called at the end of
        World.run_update, after reversion/systematics so their host
        phases land in the same record)."""
        if self._pending is None:
            return
        u, executed, dispatch, counters, tail = self._pending
        self._pending = None

        task_totals = counters["task_exe_totals"].cpu().numpy().astype(
            np.int64)
        task_triggers = task_totals - self._task_prev
        self._task_prev = task_totals

        # wall = span from this record's first bracketed phase to now; the
        # phases subdivide it (sum ~= wall minus inter-phase python
        # overhead).  Loop time between records is not update work and is
        # excluded.
        wall_ms = self.timeline.window_seconds() * 1e3
        phases = {k: round(v, 4) for k, v in self.timeline.drain().items()}

        granted_sum = int(tail["granted_sum"])
        ceiling = int(tail["ceiling_sum"])
        rec = {
            "record": "update",
            "update": int(u),
            "wall_ms": round(wall_ms, 4),
            "phases": phases,
            "counters": {
                "executed": int(executed),
                "organisms": int(counters["organisms"]),
                "births": int(counters["births"]),
                "deaths": int(counters["deaths"]),
                "divides_total": int(counters["divides_total"]),
                "task_triggers": [int(x) for x in task_triggers],
                "budget": {
                    "granted": granted_sum,
                    "ceiling": ceiling,
                    "utilization": round(granted_sum / ceiling, 4)
                    if ceiling else 1.0,
                    "block_max_max": int(tail["block_max_max"]),
                    "block_mean_mean": round(
                        float(tail["block_mean_mean"]), 2),
                },
            },
        }
        if dispatch is not None:
            rec["counters"]["dispatch_mix"] = [
                int(x) for x in dispatch.cpu().tolist()]
        self._writer.write(rec)

    def seed_task_totals(self, totals):
        """Reset the tasks-trigger diff baseline (state restore)."""
        self._task_prev = np.asarray(totals, np.int64)

    def close(self):
        self.timeline.stop_trace()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
