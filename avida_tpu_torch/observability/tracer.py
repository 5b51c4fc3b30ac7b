"""Device-side flight recorder: event codes + the host drain.

The reference engine's forensic story is per-event logs (cStats event
counters feeding the analyze mode) and per-cycle tracer hooks
(cHardwareTracer); the lockstep port's equivalent must not sync the
device mid-chunk, so it records into fixed-capacity ring buffers CARRIED
IN PopulationState (tr_update/tr_cell/tr_code/tr_payload/tr_count --
world-level fields, like lane_perm) and drains them to the host only at
update-chunk boundaries, the same deferred-snapshot pipeline the
systematics newborn drain uses (world.py).

Event catalogue (device side emits in ops/update.trace_pre_phase /
trace_post_phase; host paths append through record_host_event):

  code  name         cell        payload
  1     birth        newborn     parent cell index at birth
  2     death        dead cell   genotype id before the update (-1 unknown)
  3     task_first   cell        bitmask of newly first-executed tasks
  4     sched_stall  -1          block utilization x 10000
  5     anom_merit   cell        1 (non-finite/negative merit on alive)
  6     anom_head    cell        instruction pointer value
  7     revert       newborn     parent cell (host: offspring reverted)
  8     sterilize    newborn     fitness category (host: sterilized)

Overflow semantics: slot i % cap holds event number i, so a full ring
drops the OLDEST events; the monotone tr_count cursor recovers the drop
count at drain time (reported as "dropped" on the window's first trace
record).  The recorder never forces an early host sync.

Drained events land in the existing runlog (telemetry.jsonl) as one
{"record": "trace", "update": u, "events": [[cell, code, payload], ...]}
line per update -- trimmed on resume by runlog.trim_update_records
exactly like per-update telemetry records.  tools/trace_tool.py
converts the runlog to a Chrome/Perfetto trace.json and back.

Counterpart of avida_tpu/observability/tracer.py; the snapshot copies
are torch clones (asynchronous on the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from avida_tpu_torch.core.state import TRACE_RING_FIELDS as _RING_FIELDS
# the codes live in a torch-free module, which tools/trace_tool.py reads
# from an operator's shell
from avida_tpu_torch.observability.events import (  # noqa: F401
    DEVICE_MAX_CODE, EV_ANOM_HEAD, EV_ANOM_MERIT, EV_BIRTH, EV_DEATH,
    EV_REVERT, EV_SCHED_STALL, EV_STERILIZE, EV_TASK_FIRST, EVENT_CODES)


def ring_order(count: int, cap: int) -> np.ndarray:
    """Chronological slot order of a drained ring: event number i lives
    at slot i % cap, so with count <= cap the slots are 0..count-1 and
    with overflow the surviving events are numbers count-cap..count-1
    (oldest dropped)."""
    if count <= cap:
        return np.arange(count, dtype=np.int64)
    return np.arange(count - cap, count, dtype=np.int64) % cap


class FlightRecorder:
    """Host half of the flight recorder: deferred ring drains, drop
    accounting, host-path events (reversion), and the runlog writer.

    The device half lives in ops/update.py (emission) and core/state.py
    (the ring fields); World.run drives the snapshot/drain pipeline at
    chunk boundaries."""

    def __init__(self, world):
        self.world = world
        self.events_total = 0
        self.dropped_total = 0
        self.code_totals = {name: 0 for name in EVENT_CODES.values()}
        self.last_drain_update = None
        self._host_events = []      # (update, cell, code, payload)
        self._own_writer = None
        self._log_opened = False

    # ---- host-path emission (reversion, future host events) ----

    def record_host_event(self, update: int, cell: int, code: int,
                          payload: int):
        """Queue a host-side event for the next drain (merged into the
        per-update trace records alongside the device ring's events)."""
        self._host_events.append(
            (int(update), int(cell), int(code), int(payload)))

    # ---- the drain pipeline (mirrors World._snapshot_newborns) ----

    def snapshot(self, world) -> dict:
        """Device-side copy of the ring + cursor reset, for a DEFERRED
        drain: the copies are async device ops (no host sync); the host
        ingests the snapshot one chunk later.  Ring rows past tr_count
        are scratch after this (exactly like nb_* rows past nb_count)."""
        st = world.state
        snap = {name: getattr(st, name).clone() for name in _RING_FIELDS}
        snap["update_at"] = world.update
        snap["host_events"], self._host_events = self._host_events, []
        world.state = st.replace(tr_count=torch.zeros_like(st.tr_count))
        return snap

    def drain(self, snap: dict):
        """Host-sync a snapshot and append per-update trace records to
        the runlog.  A host sync point -- call only at event/report/exit
        boundaries (World.run's pipeline)."""
        def host(x):
            return x.detach().cpu().numpy()

        count = int(snap["tr_count"])
        cap = int(snap["tr_code"].shape[0])
        dropped = max(count - cap, 0)
        per_update: dict[int, list] = {}
        if count > 0 and cap > 0:
            order = ring_order(count, cap)
            ups = host(snap["tr_update"])[order]
            cells = host(snap["tr_cell"])[order]
            codes = host(snap["tr_code"])[order]
            pays = host(snap["tr_payload"])[order]
            for u, c, k, p in zip(ups.tolist(), cells.tolist(),
                                  codes.tolist(), pays.tolist()):
                per_update.setdefault(int(u), []).append([c, k, p])
        for u, c, k, p in snap.get("host_events", ()):
            per_update.setdefault(int(u), []).append([c, k, p])
        if not per_update and not dropped:
            self.last_drain_update = snap["update_at"]
            return
        w = self._writer()
        first = True
        for u in sorted(per_update):
            events = per_update[u]
            rec = {"record": "trace", "update": u, "events": events}
            if first and dropped:
                rec["dropped"] = dropped
            first = False
            w.write(rec)
            self.events_total += len(events)
            for c, k, p in events:
                name = EVENT_CODES.get(k)
                if name is not None:
                    self.code_totals[name] += 1
        self.dropped_total += dropped
        self.last_drain_update = snap["update_at"]

    # ---- writer plumbing ----

    def _writer(self):
        """The runlog writer: the telemetry recorder's when telemetry is
        on (trace records interleave with its update records in the same
        telemetry.jsonl), else a lazily opened writer of our own on the
        same path.  Reopens append (a second run(), or a checkpoint
        resume, must not truncate earlier records)."""
        w = self.world
        tel = getattr(w, "telemetry", None)
        if tel is not None:
            tel._ensure()
            return tel._writer
        if self._own_writer is None:
            from avida_tpu_torch.observability.runlog import TelemetryWriter
            reopen = self._log_opened or getattr(w, "_dat_append", False)
            self._own_writer = TelemetryWriter(
                os.path.join(w.data_dir, "telemetry.jsonl"),
                mode=("a" if reopen else "w"))
            self._log_opened = True
        return self._own_writer

    def close(self):
        if self._own_writer is not None:
            self._own_writer.close()
            self._own_writer = None

    # ---- checkpoint integration (utils/checkpoint.py host block) ----

    def to_snapshot(self) -> dict:
        return {
            "events_total": int(self.events_total),
            "dropped_total": int(self.dropped_total),
            "code_totals": dict(self.code_totals),
            "last_drain_update": self.last_drain_update,
        }

    def from_snapshot(self, snap: dict):
        self.events_total = int(snap.get("events_total", 0))
        self.dropped_total = int(snap.get("dropped_total", 0))
        self.code_totals.update(snap.get("code_totals", {}))
        self.last_drain_update = snap.get("last_drain_update")
        self._host_events = []
        # resume continuity: append to the preempted run's runlog
        if os.path.exists(os.path.join(self.world.data_dir,
                                       "telemetry.jsonl")):
            self._log_opened = True
