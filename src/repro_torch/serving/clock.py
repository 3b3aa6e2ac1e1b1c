"""Injectable scheduler clocks: real time, or a deterministic virtual one.

A copy of `repro.serving.clock`.

Every time-dependent decision the continuous-batching scheduler makes --
queue-wait accounting, deadline expiry, latency histograms -- reads one
`Clock` object instead of `time.monotonic()`. Production serving uses
`SystemClock` (real monotonic time). Tests use `VirtualClock`: time only
moves when the scheduler reports work (`on_steps`, a fixed cost per
fixpoint step) or the test advances it explicitly, so every interleaving
-- which query retires in which admission window, which deadline expires
mid-fixpoint -- is a pure function of the submission sequence and
replays bit-for-bit. No sleeps, no flaky timing tests.
"""
from __future__ import annotations

import dataclasses
import time


class SystemClock:
    """Real time: `now()` is `time.monotonic()`; scheduler work reports
    are no-ops (wall time advances by itself)."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def on_steps(self, n: int) -> None:
        """The scheduler ran an admission window of `n` fixpoint
        iterations; real time already accounts for it."""


@dataclasses.dataclass
class VirtualClock:
    """Deterministic logical time for replayable scheduling tests.

    `now()` returns the current logical time; it advances only via
    `advance(dt)` (explicit test control) and `on_steps(n)` (the
    scheduler reporting an admission window of `n` fixpoint iterations,
    costed at `step_cost_s` each -- the lanes of a window run in
    parallel, so a window's cost is its iteration count, not the sum of
    per-lane steps). With every time source under test control, a
    deadline expiring in window 3 of a rotating batch is an assertable
    fact, not a race.
    """

    step_cost_s: float = 1.0
    t: float = 0.0
    virtual = True

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"virtual time cannot rewind (advance({dt}))")
        self.t += float(dt)

    def on_steps(self, n: int) -> None:
        self.t += float(n) * self.step_cost_s
