"""JSONL record files with size-capped rotation, without torch.

The one spelling of the append discipline every run log of the port
shares: the supervisor's supervisor.jsonl (service/supervisor.py), the
fleet's fleet.jsonl (service/fleet.py), the integrity plane's
integrity.jsonl, the analytics log, the history rings and the alert
journal (observability/history.py), perf.jsonl.  A file
that would grow past its byte cap is moved aside to `<path>.1` (one
atomic rename, clobbering the previous aside) and the record starts a
fresh file; readers take the pair oldest first and skip a torn final
line.  Counterpart of `append_record` / `read_records` in
avida_tpu/observability/runlog.py, kept in a module of its own so the
processes that must never load torch -- the supervisor, the fleet
orchestrator, the ops tools, `--status` -- can write and read run logs.
"""

from __future__ import annotations

import json
import os


def append_record(path: str, rec: dict, max_bytes: int | None = None,
                  durable: bool = True):
    """Crash-safe single-record append: open, append one line, optionally
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
            # durable=False is the hot-loop flavor (per-chunk digest
            # records, history samples): skip the per-record fsync -- a
            # crash can only tear the final line, which every reader
            # here tolerates
            os.fsync(f.fileno())


def read_records(path: str) -> list:
    """All JSON records across the rotation pair (`<path>.1` then
    `<path>`), oldest first, torn/garbage lines skipped."""
    out = []
    for p in (path + ".1", path):
        try:
            f = open(p)
        except OSError:
            continue
        with f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue            # torn tail from a crash
    return out
