"""The attribution plane's host-side readers, without torch: what
tools/perf_tool.py needs to report a run directory and to diff two
bench artifacts.  observability/profiler.py writes what this reads
(DATA_DIR/perf.jsonl, the avida_perf_* families of metrics.prom); the
bench artifacts and their provenance block are the reference's
(bench.py; the port's bench is ROADMAP item 8)."""

from __future__ import annotations

import json
import os

from avida_tpu_torch.observability.records import read_records

PERF_FILE = "perf.jsonl"
# the apples-to-apples fields perf_tool diff refuses to cross
PROVENANCE_STRICT = ("platform", "device_kind", "device_count", "x64",
                     "code")


def read_perf_records(data_dir: str) -> list:
    """The perf records across the rotation pair, oldest first (torn
    lines skipped)."""
    return [rec for rec in read_records(os.path.join(data_dir, PERF_FILE))
            if rec.get("record") == "perf"]


def read_prom(path: str) -> dict:
    """{family or family{labels}: float} from one .prom snapshot (the
    history.parse_exposition grammar); {} when the file is unreadable."""
    out = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, _, val = line.rpartition(" ")
                try:
                    out[name] = float(val)
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def provenance_mismatches(a: dict, b: dict) -> list:
    """The strict-field disagreements between two provenance blocks --
    what makes a diff apples-to-oranges.  Either side absent -> a
    single loud "no provenance" entry."""
    if not a or not b:
        return [("provenance", "absent" if not a else "present",
                 "absent" if not b else "present")]
    return [(f, a.get(f), b.get(f)) for f in PROVENANCE_STRICT
            if a.get(f) != b.get(f)]


def load_bench_json(path: str) -> dict:
    """One bench artifact from `path`: a JSON object, or the LAST object
    line of a JSONL stream."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        last = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    last = json.loads(line)
                except ValueError:
                    continue
        if last is None:
            raise
        return last
