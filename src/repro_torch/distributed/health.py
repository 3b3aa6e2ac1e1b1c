"""Fault tolerance: heartbeat monitoring and the train step's guard.

The port's copy of `repro.distributed.health`:

  * HeartbeatMonitor: the bucket graph server
    (`repro_torch.launch.serve_graph.GraphServer`) `beat()`s before and
    after every dispatch, the trainer (`repro_torch.launch.train`) every
    step; a watchdog thread flags a stall (a hung kernel, a dead host, an
    injected 'stall' fault) after `timeout_s` and invokes the registered
    callback, then re-arms on the next beat.
  * step_guard: wraps one train step; turns an error into a StepFailure
    carrying the step index, so the supervisor's log shows where.
"""
from __future__ import annotations

import dataclasses
import threading
import time


class StepFailure(RuntimeError):
    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"step {step} failed: {cause!r}")
        self.step = step
        self.cause = cause


@dataclasses.dataclass
class HeartbeatMonitor:
    """Watchdog over a loop that `beat()`s every step.

    The watchdog thread flags a stall (no beat for `timeout_s`) exactly
    once per stall episode -- `stalled` latches True, `stall_count`
    increments, `on_stall` fires -- then keeps watching: the next
    `beat()` re-arms it, so a monitor survives any number of stalls
    (the serving layer's injected step-stalls rely on this). `stop()`
    is synchronous: it wakes the watchdog, joins it, and holds the
    state lock while doing so, so no `on_stall` callback can start
    after `stop()` returns.
    """
    timeout_s: float = 300.0
    on_stall: callable = None
    poll_s: float | None = None     # watchdog wake interval (default
                                    # timeout_s/4, capped at 5s)
    stalled: bool = False           # latched until the next beat()
    stall_count: int = 0            # lifetime stall episodes

    def __post_init__(self):
        self._last = time.monotonic()
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self):
        with self._lock:
            self._last = time.monotonic()
            self.stalled = False            # re-arm for the next stall

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._wake.clear()
        poll = self.poll_s if self.poll_s else min(self.timeout_s / 4, 5.0)

        def watch():
            while not self._wake.wait(poll):
                # the callback runs under the lock: stop() also takes
                # it, so shutdown can never race a stall notification
                with self._lock:
                    if self._wake.is_set():
                        return
                    if self.stalled:        # flagged; wait for a beat
                        continue
                    if time.monotonic() - self._last > self.timeout_s:
                        self.stalled = True
                        self.stall_count += 1
                        if self.on_stall is not None:
                            self.on_stall()

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
        self._thread = None


def step_guard(fn, step: int):
    """Run one step, wrapping failures with their step index."""
    try:
        return fn()
    except Exception as e:                      # noqa: BLE001
        raise StepFailure(step, e) from e
