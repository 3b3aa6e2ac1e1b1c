"""The traffic: query streams from the seed, and the two loops that drive
the port with them.

* closed loop (`closed_loop`): one client; each call is
  ``compile(graph, program).query(sources)`` with the mix's batch of
  sources, the next sent when the last returns, until the window ends.
* open loop (`open_loop`): requests arrive on a schedule drawn from the
  seed (a Poisson process: the same set of exponential gaps for every
  seed, in the seed's order) at the mix's fixed rate, whatever the
  server does; `AsyncGraphServer.submit` admits each when due, and
  `pump` advances the server between arrivals. Each request is timed
  from its scheduled arrival to its retirement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from flipbench.devtrace import span


@dataclasses.dataclass
class QueryRecord:
    """One closed-loop call: its sources and the port's step counts."""
    program: str
    srcs: np.ndarray          # (B,)
    steps: np.ndarray         # (B,)
    converged: bool
    traced: bool


@dataclasses.dataclass
class RequestRecord:
    """One open-loop request, on the server's monotonic clock."""
    algo: str
    src: int
    t_sched: float
    t_submit: float = float("nan")
    t_retire: float = float("inf")       # inf: never retired
    ok: bool = False
    steps: int = 0
    queue_wait_s: float = float("inf")
    service_s: float = float("inf")

    @property
    def latency_s(self) -> float:
        return self.t_retire - self.t_sched if self.ok else float("inf")


class Sources:
    """Sources drawn uniformly from the mix's eligible vertices: those
    with at least one edge (Graph500's rule for roots)."""

    def __init__(self, raw, rng: np.random.Generator):
        self.eligible = np.flatnonzero(raw.degree() > 0)
        self.rng = rng

    def draw(self, k: int) -> np.ndarray:
        return self.eligible[self.rng.integers(0, len(self.eligible), k)]


class Reservoir:
    """A seeded uniform sample of k items from a stream of unknown length
    (algorithm R), plus the item with the most steps."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.slots: list = []
        self.longest = None
        self.seen = 0

    def offer(self, steps: int, item) -> None:
        if len(self.slots) < self.k:
            self.slots.append((self.seen, item))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = (self.seen, item)
        if self.longest is None or steps > self.longest[0]:
            self.longest = (steps, self.seen, item)
        self.seen += 1

    def items(self) -> list:
        kept = dict(self.slots)
        if self.longest is not None:
            kept.setdefault(self.longest[1], self.longest[2])
        return [kept[i] for i in sorted(kept)]


def closed_loop(cq, traffic: dict, seconds: float, sources: Sources,
                sample: Reservoir, recorder=None):
    """Run the closed loop for `seconds`; the first `trace_seconds` of
    it (whole calls) under `recorder` when given. Returns the records
    and the window's length: the end of the last call, which is the
    first to end past `seconds`."""
    batch = int(traffic["batch"])
    scalar = bool(traffic.get("scalar", False))
    program = traffic["program"]
    trace_s = float(traffic["trace_seconds"])
    records = []
    tracing = recorder is not None
    stack = contextlib.ExitStack()
    if tracing:
        recorder.start()
        stack.enter_context(recorder.window())
    t_start = time.perf_counter()
    while True:
        srcs = sources.draw(batch)
        with span("flipbench.query") if tracing else contextlib.nullcontext():
            r = cq.query(int(srcs[0]) if scalar else srcs)
        t1 = time.perf_counter()
        steps = np.atleast_1d(np.asarray(r.steps))
        rec = QueryRecord(program=program, srcs=srcs, steps=steps,
                          converged=r.all_converged, traced=tracing)
        records.append(rec)
        sample.offer(int(steps.max()),
                     (program, srcs, np.atleast_2d(r.attrs)))
        if tracing and t1 - t_start >= trace_s:
            stack.close()
            recorder.stop()
            tracing = False
        if t1 - t_start >= seconds:
            break
    stack.close()
    if recorder is not None:
        recorder.stop()
    return records, t1 - t_start


def arrivals(traffic: dict, seconds: float, sources: Sources,
             rng: np.random.Generator) -> list[RequestRecord]:
    """The open loop's schedule: N = rate x seconds arrivals over the
    window, the first at its start, whose gaps are the N exponential
    quantiles at (i + 0.5) / N, scaled to sum to the window, in the
    seed's order; each
    request's program follows the mix's weights, the same count of each
    for every seed, in the seed's order; sources uniform."""
    rate = float(traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    weights = traffic["programs"]
    names = sorted(weights)
    share = np.asarray([float(weights[k]) for k in names])
    counts = np.floor(share / share.sum() * n).astype(int)
    counts[: n - counts.sum()] += 1
    algos = rng.permutation(np.repeat(np.arange(len(names)), counts))
    srcs = sources.draw(n)
    return [RequestRecord(algo=names[a], src=int(s), t_sched=float(o))
            for a, s, o in zip(algos, srcs, offsets)]


def open_loop(server, traffic: dict, seconds: float,
              plan: list[RequestRecord], keep: set, recorder=None):
    """Serve `plan` (offsets from the window's start) on `server` and
    wait for every request, at most `drain_limit_s` past the window's
    close. The results of the requests in `keep` and of the one with the
    most steps are kept. With `recorder`, the window's last
    `trace_seconds` are the traced window; the profiler starts there and
    stops once every request is in, so that its stop, which processes
    the trace, delays no request.
    Returns ``(kept results {index: (algo, src, attrs)}, lateness
    (submit - scheduled) seconds per request, every pump as (seconds,
    offset in the window))``."""
    limit = float(traffic["drain_limit_s"])
    trace_from = seconds - float(traffic["trace_seconds"])
    t0 = time.monotonic()
    for rec in plan:
        rec.t_sched += t0
    stop = t0 + seconds + limit
    pending: list = []
    kept: dict = {}
    longest = (-1, None)
    pumps: list = []                 # (pump seconds, offset)
    stack = contextlib.ExitStack()
    traced = "before" if recorder is not None else "never"
    i = 0

    def harvest():
        nonlocal longest
        still = []
        for j, req in pending:
            if not req.done:
                still.append((j, req))
                continue
            rec = plan[j]
            rec.ok = bool(req.ok and req.converged)
            rec.steps = int(req.steps or 0)
            rec.queue_wait_s = float(req.queue_wait_s)
            rec.service_s = float(req.service_s)
            if rec.ok:
                rec.t_retire = (req.t_submit + req.queue_wait_s
                                + req.service_s)
                item = (rec.algo, rec.src, req.result)
                if j in keep:
                    kept[j] = item
                if rec.steps > longest[0]:
                    longest = (rec.steps, (j, item))
        pending[:] = still

    while True:
        now = time.monotonic()
        if traced == "before" and now >= t0 + trace_from:
            recorder.start()
            stack.enter_context(recorder.window())
            traced = "on"
        elif traced == "on" and now >= t0 + seconds:
            stack.close()
            traced = "done"
        with span("flipbench.submit") if traced == "on" \
                else contextlib.nullcontext():
            while i < len(plan) and plan[i].t_sched <= now:
                rec = plan[i]
                req = server.submit(rec.algo, rec.src)
                rec.t_submit = req.t_submit
                pending.append((i, req))
                i += 1
        if server.pending:
            t_pump = time.monotonic()
            with span("flipbench.pump") if traced == "on" \
                    else contextlib.nullcontext():
                server.pump()
            pumps.append((time.monotonic() - t_pump, t_pump - t0))
        harvest()
        if not server.pending:
            if i >= len(plan):
                break
            wait = plan[i].t_sched - time.monotonic()
            if wait > 0:
                if traced == "on":
                    wait = min(wait, t0 + seconds - time.monotonic())
                elif traced == "before":
                    wait = min(wait, t0 + trace_from - time.monotonic())
                with span("flipbench.idle") if traced == "on" \
                        else contextlib.nullcontext():
                    time.sleep(max(wait, 0.0))
        if time.monotonic() > stop:
            break
    stack.close()
    if recorder is not None:
        recorder.stop()
    if longest[1] is not None:
        kept.setdefault(*longest[1])
    lateness = [r.t_submit - r.t_sched for r in plan[:i]]
    return kept, lateness, pumps
