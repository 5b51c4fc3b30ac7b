"""Phase wall-clock timers with device fencing.

Counterpart of avida_tpu/observability/timeline.py.  A `Timeline`
brackets named phases of an update and accumulates wall time per phase
name.  Device phases are fenced: CUDA work is asynchronous, so an
unfenced bracket measures enqueue time.  `Timeline.run(name, fn, *args)`
calls the function and, on the card, `torch.cuda.synchronize`s inside
the bracket; `Timeline.phase(name)` brackets host work.

Fencing serializes what the card would overlap, so a staged update's
phase sum is an upper bound on the unfenced update.

`start_trace(dir)` / `stop_trace()` wrap `torch.profiler` so a telemetry
run can drop a Chrome trace of its first few updates (`trace.json`)
next to the phase numbers.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


def fence(device=None):
    """Wait for the card's queued work (a no-op without CUDA)."""
    if torch.cuda.is_available() and (device is None
                                      or torch.device(device).type == "cuda"):
        torch.cuda.synchronize()


class Timeline:
    """Accumulates {phase name -> seconds} between `drain()` calls."""

    def __init__(self, device=None):
        self.device = device
        self._acc: dict[str, float] = {}
        self._order: list[str] = []
        self._window_start: float | None = None
        self._tracing = False
        self._prof = None
        self._trace_dir = None

    # ---- phase brackets ----

    def add(self, name: str, seconds: float):
        if name not in self._acc:
            self._acc[name] = 0.0
            self._order.append(name)
        self._acc[name] += seconds

    def _open(self) -> float:
        t0 = time.perf_counter()
        if self._window_start is None:
            self._window_start = t0      # first bracket since last drain
        return t0

    def run(self, name: str, fn, *args):
        """Time `fn(*args)` as phase `name`, fencing the device.  Returns
        the output."""
        t0 = self._open()
        out = fn(*args)
        fence(self.device)
        self.add(name, time.perf_counter() - t0)
        return out

    @contextmanager
    def phase(self, name: str):
        """Host-side phase bracket (no fence)."""
        t0 = self._open()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    # ---- readout ----

    def window_seconds(self) -> float:
        """Wall time from the first bracket opened since the last drain
        to now (the span the accumulated phases subdivide)."""
        if self._window_start is None:
            return 0.0
        return time.perf_counter() - self._window_start

    def drain(self) -> dict[str, float]:
        """Return accumulated {name: milliseconds} in first-seen order and
        reset the accumulator."""
        out = {n: self._acc[n] * 1e3 for n in self._order}
        self._acc = {}
        self._order = []
        self._window_start = None
        return out

    def peek_ms(self) -> dict[str, float]:
        return {n: self._acc[n] * 1e3 for n in self._order}

    # ---- torch.profiler trace capture ----

    def start_trace(self, profile_dir: str) -> bool:
        """Begin a torch.profiler capture whose Chrome trace goes to
        `profile_dir`/trace.json at stop_trace (idempotent; returns
        whether a capture is now running)."""
        if self._tracing:
            return True
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(profile_dir, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._trace_dir = profile_dir
            self._tracing = True
        except Exception as e:
            # profiler unavailable, unwritable dir, or a capture already
            # active: the run continues without a trace, but says why
            import sys
            print(f"[avida_tpu_torch] warning: torch.profiler trace "
                  f"capture into {profile_dir!r} failed ({e}); continuing "
                  f"without a trace", file=sys.stderr)
            self._prof = None
            self._tracing = False
        return self._tracing

    def stop_trace(self):
        if not self._tracing:
            return
        prof, self._prof = self._prof, None
        self._tracing = False
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(self._trace_dir,
                                                  "trace.json"))
        except Exception as e:
            import sys
            print(f"[avida_tpu_torch] warning: writing the torch.profiler "
                  f"trace into {self._trace_dir!r} failed ({e})",
                  file=sys.stderr)
