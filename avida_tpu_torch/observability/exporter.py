"""Prometheus-style exposition text: only what the analytics pipeline
needs (analyze/pipeline.py publishes DATA_DIR/analytics.prom through it).

Counterpart of avida_tpu/observability/exporter.py:102-158
(render_families, write_metrics).  The rest of the reference's exporter
-- the run heartbeat metrics.prom under TPU_METRICS, `--status` -- is
ROADMAP item 15 and not ported yet.
"""

from __future__ import annotations

import os


def render_families(families) -> str:
    """Generic exposition renderer: families is an iterable of
    (name, kind, help, value) where value is a scalar or a
    {'label="x"': value} dict (one sample line per label set)."""
    lines = []
    for name, kind, help_, value in families:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        if isinstance(value, dict):
            for label, v in sorted(value.items()):
                lines.append(f"{name}{{{label}}} {v}")
        else:
            lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


def write_metrics(path: str, text: str, durable: bool = True):
    """Atomic publish: a scraper never sees a half-written file.
    `durable=False` skips the fsync (the rename alone keeps the file
    torn-proof)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
