"""Structured run events and the resume trims: the part of
avida_tpu/observability/runlog.py that persistence calls.

  * emit_event -- one out-of-band run event, echoed to stderr;
  * trim_update_records -- resume continuity for a per-update JSONL log;
  * append_record -- the crash-safe single-record append behind the
    integrity plane's integrity.jsonl.

The telemetry recorder and its writer are not ported yet (ROADMAP.md
Queue 1 item 15); TPU_TELEMETRY stays refused by World.
"""

from __future__ import annotations

import json
import os
import sys


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


def append_record(path: str, rec: dict, max_bytes: int | None = None,
                  durable: bool = True):
    """Crash-safe single-record append (the integrity plane's
    {"record": "integrity"} lines): open, append one line, optionally
    fsync, close -- a torn tail can only ever be the final line.  With
    `max_bytes` set, a file that would grow past the cap is first moved
    aside to `<path>.1` and the record starts a fresh file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    line = json.dumps(rec) + "\n"
    if max_bytes:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size and size + len(line) > max_bytes:
            os.replace(path, path + ".1")
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        if durable:
            # durable=False is the hot-loop flavor (the integrity
            # plane's per-chunk digest records): skip the per-record
            # fsync -- a crash can only tear the final line, which
            # every runlog reader already tolerates
            os.fsync(f.fileno())


def emit_event(world, event: str, **fields):
    """Structured out-of-band run event ({"record": "event", ...}).

    The checkpoint/resume machinery (utils/checkpoint.py) and the
    integrity plane report through this: echoed to stderr (checkpoint
    corruption fallback, restores, state divergence), in the
    reference's words.  `world` is the run reporting (its telemetry
    writer is not ported yet).  Never raises -- a logging failure must
    not take down the save/restore path it is reporting on."""
    try:
        detail = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[avida_tpu_torch] {event}" + (f": {detail}" if detail else ""),
              file=sys.stderr)
    except Exception:
        pass
