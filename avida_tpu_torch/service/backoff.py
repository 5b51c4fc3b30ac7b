"""Restart pacing: exponential backoff, decorrelated jitter, retry budget.

The supervisor must neither hammer a crash-looping run (a config error
would relaunch at full speed forever) nor synchronize a fleet of
restarting tenants into a thundering herd.  The standard answer is
capped exponential backoff with DECORRELATED jitter: each delay is drawn
uniformly from [base, 3 * previous_delay] and clipped to the cap, so
consecutive delays grow roughly exponentially but two supervisors that
failed at the same instant diverge immediately.

The retry BUDGET is the give-up bound: `max_retries` consecutive
failures and the supervisor stops (a human's problem now).  A child that
stays healthy for `healthy_sec` refills the budget -- a run that fails
once a day for a month is healthy-with-hiccups, not crash-looping, and
must not exhaust a lifetime counter.

Pure host code with an injected RNG seed and no reads of the wall
clock: callers pass elapsed-healthy time in, so unit tests drive it with
a fake clock and zero real sleeps.  A copy of avida_tpu/service/backoff.py:
the same seed and the same calls give the same delays and budget.
"""

from __future__ import annotations

import random


class RetryPolicy:
    def __init__(self, max_retries: int = 8, base: float = 1.0,
                 cap: float = 60.0, healthy_sec: float = 300.0,
                 seed: int = 0):
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap (got {base}, {cap})")
        self.max_retries = int(max_retries)
        self.base = float(base)
        self.cap = float(cap)
        self.healthy_sec = float(healthy_sec)
        self._rng = random.Random(seed)
        self.failures = 0
        self._prev = self.base

    def can_retry(self) -> bool:
        return self.failures < self.max_retries

    def budget_left(self) -> int:
        return max(self.max_retries - self.failures, 0)

    def next_delay(self) -> float:
        """Record one failure and return the sleep before the next
        launch.  Decorrelated jitter: uniform in [base, 3*prev], clipped
        to cap.  Call only while can_retry()."""
        self.failures += 1
        delay = min(self.cap, self._rng.uniform(self.base, self._prev * 3))
        self._prev = delay
        return delay

    def note_healthy(self, healthy_elapsed: float) -> bool:
        """Report continuous-healthy child time; once it reaches
        healthy_sec the failure budget and the backoff ladder reset.
        Returns True when a reset happened."""
        if healthy_elapsed >= self.healthy_sec and (
                self.failures or self._prev != self.base):
            self.failures = 0
            self._prev = self.base
            return True
        return False
