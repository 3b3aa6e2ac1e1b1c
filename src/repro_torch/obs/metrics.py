"""Metrics registry: counters, gauges, and quantile histograms.

The port's copy of `repro.obs.metrics` (pure Python). The runtime
layers (the serving front-end, `chip_smoke.py`) record what they
actually did -- requests, cache hits, latencies, windows -- into one
`MetricsRegistry`, and everything downstream (server `stats()`, logs)
reads the same snapshot schema instead of scraping prints.

`PROGRAM` is the process-wide registry of the engine's always-on
counters, one integer add each per fixpoint chunk or fixpoint:

  * ``fixpoint.chunks`` -- chunks run (a host-loop step is a chunk of
    one); each is followed by one device->host read, and the host loop
    makes one read more per fixpoint, the one that finds it done;
  * ``fixpoint.steps_enqueued`` -- the steps those chunks enqueue;
  * ``fixpoint.iterations`` -- each fixpoint's largest per-query step
    count, so ``steps_enqueued - iterations`` are the device loop's
    no-op steps past the fixpoint.

Design constraints, in order:

  * **cheap on the hot path** -- `Counter.inc` / `Histogram.observe`
    are one attribute update; nothing is formatted or flushed until a
    snapshot or export is requested;
  * **bounded memory** -- histograms keep a fixed-capacity reservoir
    (uniform per-observation replacement once full), so a server that
    lives for millions of requests never grows an unbounded value list
    while p50/p95/p99 stay representative; exact count/sum/min/max are
    always maintained besides the reservoir;
  * **JSON all the way down** -- `snapshot()` returns plain
    dict/list/float structures that `json.dump` accepts unmodified.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading


@dataclasses.dataclass
class Counter:
    """Monotone event count. `inc()` only ever adds a non-negative n."""
    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        self.value += n

    def snapshot(self):
        return self.value


@dataclasses.dataclass
class Gauge:
    """Last-written value of a quantity that moves both ways."""
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, delta: float) -> None:
        """Relative move (either direction) -- queue depths and
        occupancy counts adjust by deltas at admission/retirement
        instead of recomputing the absolute level."""
        self.value += float(delta)

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming distribution with exact count/sum/min/max plus a
    fixed-capacity uniform reservoir for the quantile estimates, so a
    long-lived server's latency histogram costs O(capacity) memory
    regardless of traffic."""

    def __init__(self, name: str, capacity: int = 2048,
                 seed: int = 0x5EED):
        self.name = name
        self.capacity = int(capacity)
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._reservoir: list[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._reservoir) < self.capacity:
            self._reservoir.append(v)
        else:                      # uniform replacement (Algorithm R)
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._reservoir[j] = v

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the reservoir (exact while fewer
        than `capacity` observations have been made)."""
        if not self._reservoir:
            return 0.0
        vals = sorted(self._reservoir)
        i = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
        return vals[i]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": 0.0 if self.min is None else self.min,
            "max": 0.0 if self.max is None else self.max,
            "mean": (self.total / self.count) if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create store of named metrics.

    Metric names are free-form dotted strings (``latency_s.bfs``); the
    registry never interprets them. Access is thread-safe at the
    metric-creation level (the serving front-end may grow async later);
    individual observations rely on the GIL like the rest of the stack.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # ------------------------------------------------------------ #
    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, capacity: int = 2048) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, capacity)
            return self._histograms[name]

    def sum_counters(self, prefix: str) -> int:
        """Total across every counter whose name starts with `prefix` --
        e.g. ``sum_counters("fallback.")`` for the degradation-ladder
        total or ``sum_counters("shed.")`` for requests shed across
        algebras."""
        with self._lock:
            return sum(c.value for n, c in self._counters.items()
                       if n.startswith(prefix))

    # ------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """One JSON-ready view of every metric."""
        return {
            "counters": {n: c.snapshot()
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.snapshot()
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._histograms.items())},
        }

    def write_snapshot_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


PROGRAM = MetricsRegistry()
