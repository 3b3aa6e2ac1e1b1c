"""Continuous-batching scheduler: a rotating fixpoint batch per algebra.

The port of `repro.serving.scheduler`. A bucket server dispatches
fixed-size buckets: a query arriving one step after a dispatch waits
out the *entire* previous fixpoint, and every bucket waits for its
slowest member. This scheduler applies Flip's own data-centric idea at
the request level -- work is admitted by the runtime state of the
system, not a static schedule:

  * each algebra owns ONE long-lived (B, ntiles, T[, d]) fixpoint state
    on the session's device -- the *rotating batch* -- whose B lanes
    hold independent in-flight queries (or sit inert);
  * the fixpoint advances in bounded segments of K steps
    (`FlipEngine.run_segment`, the step-boundary yield hook): at every
    segment boundary the scheduler retires converged lanes, refills
    them from the request queue, and enforces deadlines -- so a new
    query joins the warm batch within K steps instead of waiting out a
    whole bucket;
  * lanes are independent along the batch axis, so every retired
    query's result is bit-for-bit its solo run, under any admission
    interleaving (for the idempotent programs; pagerank and labelprop
    within `VertexAlgebra.atol`);
  * a bounded LRU `ResultCache` keyed (graph fingerprint, algebra, src)
    short-circuits repeated sources entirely, and across one graph
    update the superseded generation's converged results become
    warm-start candidates (exactly one version step, monotone deltas
    only);
  * all timing flows through an injectable `Clock`: with a
    `VirtualClock` every interleaving -- admissions, retirements,
    deadline expiries -- is a deterministic, replayable function of the
    submission sequence.

`AsyncGraphServer` is the request-level front door (`submit` / `update`
/ `drain` / `serve` / `stats`). On the card every window's steps are
launches of the frontier-relax kernel. A window that raises fails its
occupied lanes with typed errors (`classify`) and the stream keeps
serving. As in the reference, this scheduler retries nothing: the
degradation ladder (`resilience.fallback_chain`) belongs to the bucket
server (`repro_torch.launch.serve_graph.GraphServer`), and on the card
its rungs all launch the kernel.

The server's host work carries program spans (`repro_torch.obs.span`):
`flip.pump` over each `pump`, `flip.admit` over one lane's admission,
`flip.window` over one algebra's K-step segment and `flip.retire` over
one lane's retirement; those of one request carry its `req_id` as `req`.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch import api as flip
from repro_torch.algebra import get_algebra
from repro_torch.api import CompiledQuery, ExecutionPlan
from repro_torch.graphs.csr import Graph
from repro_torch.obs import MetricsRegistry, span
from repro_torch.resilience import (CapacityExceeded, ConvergenceFailure,
                                    DeadlineExceeded, InvalidRequest,
                                    classify)
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.clock import SystemClock
from repro_torch.serving.request import ServeRequest


class RotatingBatch:
    """One algebra's continuously-batched fixpoint: B lanes of state,
    a request (or None) per lane, and per-lane admission bookkeeping.
    The scheduler owns the policy; this owns the lane mechanics.

    The resident state stays on the session's device between windows:
    an admission writes one lane's rows into the device tensors, and
    only a retiring lane is read back. Solo initial states are memoized
    per source (as clones on the device, cap 1,024) -- Zipf traffic
    repeats sources constantly, and a cold miss's init is the same
    host-built tiled scatter and copy every time."""

    def __init__(self, session: CompiledQuery, nslots: int):
        self.cq = session
        self.engine = session.engine
        self.nslots = int(nslots)
        self.state = self.engine.idle_state(self.nslots)
        self.slots: list[ServeRequest | None] = [None] * self.nslots
        self.t_admit = [0.0] * self.nslots
        self.windows = 0
        self._init_cache: dict[int, tuple] = {}

    @property
    def occupied(self) -> list[int]:
        return [b for b, r in enumerate(self.slots) if r is not None]

    @property
    def idle(self) -> list[int]:
        return [b for b, r in enumerate(self.slots) if r is None]

    def _solo_init(self, src: int, warm):
        """(attrs, aux, frontier) rows of one freshly initialized (or
        warm-resumed) solo query. Cold inits are memoized per source;
        warm resumes depend on the candidate attrs, so they are not."""
        if warm is None:
            init = self._init_cache.get(src)
            if init is None:
                if len(self._init_cache) >= 1024:
                    self._init_cache.clear()
                # clones: a memo entry owns its storage, it is never a
                # view of a tensor anything else writes
                init = tuple(x[0].clone() for x in
                             self.engine.initial_state([int(src)]))
                self._init_cache[src] = init
            return init
        return tuple(x[0] for x in
                     self.engine.initial_state([int(src)], warm=warm))

    def admit(self, b: int, req: ServeRequest, now: float,
              warm=None) -> None:
        """Write `req`'s solo state into lane `b` (in-place writes into
        the device state); queue wait ends here."""
        a1, x1, f1 = self._solo_init(req.src, warm)
        attrs, aux, frontier = self.state
        attrs[b], aux[b], frontier[b] = a1, x1, f1
        self.slots[b] = req
        self.t_admit[b] = now
        req.slot = b
        req.steps = 0
        req.queue_wait_s = now - req.t_submit

    def evict(self, b: int) -> ServeRequest:
        """Free lane `b` (retirement or failure). The lane's state is
        left as-is -- a converged lane's frontier is already empty, so
        it is inert until the next `admit` overwrites it."""
        req, self.slots[b] = self.slots[b], None
        return req

    def reset(self) -> None:
        """All lanes idle (the failure-isolation path): ⊕-identity
        attrs, empty frontiers."""
        self.state = self.engine.idle_state(self.nslots)
        self.slots = [None] * self.nslots

    def finalize_lane(self, b: int) -> np.ndarray:
        """Original-vertex-order result of lane `b` alone."""
        attrs, aux, _ = self.state
        return self.engine.finalize_state(attrs[b:b + 1], aux[b:b + 1])[0]

    def budget_left(self, b: int) -> int:
        """Steps lane `b` may still take before its budget (per-request
        `max_steps`, else the session valve) exhausts."""
        req = self.slots[b]
        cap = (self.engine.max_steps if req.max_steps is None
               else req.max_steps)
        return max(0, cap - (req.steps or 0))

    def run_window(self, k: int):
        """One bounded segment: every occupied lane advances at most
        ``min(k, budget_left)`` steps. Returns ``(steps, converged,
        iterations)`` -- per-lane steps taken, the end-of-segment
        convergence mask, and the window's iteration count (its cost on
        the clock: lanes run in parallel, so a window costs its longest
        lane, not the sum)."""
        budgets = np.zeros(self.nslots, dtype=np.int32)
        for b in self.occupied:
            budgets[b] = min(int(k), self.budget_left(b))
        # run_segment hands back the steps' new tensors (or torch.where
        # of them; a monotone algebra's aux, which no step reads, passes
        # through), and on one stream an in-place lane write runs after
        # every kernel enqueued before it: the next admission never
        # writes a buffer that a step still reads
        self.state, steps, converged = self.engine.run_segment(
            self.state, budgets)
        self.windows += 1
        for b in self.occupied:
            self.slots[b].steps += int(steps[b])
        return steps, converged, int(steps.max(initial=0))


@dataclasses.dataclass
class AsyncGraphServer:
    """Continuous-batching graph-query server with a shared result
    cache.

    Pass a full `plan` (its `batch` is the rotating-batch width B), or
    the per-knob fields which fold into one plan at construction, plus
    the scheduler knobs:

    segment_steps  -- K, the admission window: converged lanes retire
                      and queued queries are admitted every K fixpoint
                      steps. Smaller K = lower admission latency, more
                      host sync; K is a latency/throughput knob only,
                      results are bit-exact at any K.
    lanes          -- rotating-batch width PER ALGEBRA (default: the
                      plan's batch). Mixed-algebra traffic splits load
                      across per-algebra batches, so narrower lanes
                      keep per-window occupancy (and utilization) high;
                      another policy knob, never a semantics one.
    cache_capacity -- bounded LRU result-cache entries (0 disables).
    warm_reuse     -- resume repeated sources from the superseded
                      generation's cached fixpoints across one graph
                      update (monotone deltas only; always exact).
    clock          -- `SystemClock` (default) or a `VirtualClock` for
                      deterministic replay.
    device         -- where the sessions run: the CUDA device by
                      default; "cpu" runs the plain version.
    """

    graph: Graph
    batch: int = 8
    tile: int = 128
    mode: str = "data"
    relax_mode: str = "auto"
    compact: bool | str = "auto"
    plan: ExecutionPlan | None = None
    segment_steps: int = 4
    lanes: int | None = None
    cache_capacity: int = 256
    warm_reuse: bool = True
    max_queue_depth: int = 0     # pending-queue bound per algebra
    quotas: dict | None = None   # per-algo overrides of max_queue_depth
    clock: object = None         # SystemClock | VirtualClock
    device: object = None        # torch device of the sessions

    def __post_init__(self):
        if self.plan is None:
            self.plan = ExecutionPlan(
                mode=self.mode, relax_mode=self.relax_mode,
                compact=self.compact, tile=self.tile, batch=self.batch)
        elif self.plan.batch:
            self.batch = self.plan.batch
        else:
            self.plan = dataclasses.replace(self.plan, batch=self.batch)
        if self.plan.distributed or self.plan.mesh is not None:
            raise ValueError(
                "continuous batching drives the local segment surface "
                "(run_segment); the distributed fixpoint has none -- "
                "serve distributed plans through the bucket GraphServer")
        if self.batch < 1:
            raise ValueError(
                f"rotating batch needs >= 1 slot, got batch={self.batch}")
        if self.lanes is None:
            self.lanes = self.batch
        if not isinstance(self.lanes, int) or self.lanes < 1:
            raise ValueError(
                f"lanes must be a positive int, got {self.lanes!r}")
        if not isinstance(self.segment_steps, int) \
                or self.segment_steps < 1:
            raise ValueError(
                f"segment_steps must be a positive int, got "
                f"{self.segment_steps!r}")
        if self.clock is None:
            self.clock = SystemClock()
        self.cache = ResultCache(self.cache_capacity)
        self._batches: dict[str, RotatingBatch] = {}
        self._queues: dict[str, deque] = {}
        # per-algebra (delta, {src: frozen attrs}) from the last update:
        # warm-start candidates, valid for exactly this graph version
        self._warm: dict[str, tuple] = {}
        self._next_id = 0
        self.windows = 0         # lifetime admission-window ordinal
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.updates_applied = 0
        self.metrics = MetricsRegistry()

    # ------------------------------------------------------------ #
    @property
    def pending(self) -> int:
        """Requests not yet retired: queued + in-flight."""
        return (sum(len(q) for q in self._queues.values())
                + sum(len(rb.occupied) for rb in self._batches.values()))

    def session(self, algo: str) -> CompiledQuery:
        """The compiled session backing `algo`'s rotating batch (built
        lazily on first use, stepped across graph updates)."""
        return self._batch(algo).cq

    def _batch(self, algo: str) -> RotatingBatch:
        rb = self._batches.get(algo)
        if rb is None:
            self._check_algo(algo)
            cq = flip.compile(self.graph, algo, self.plan,
                              device=self.device)
            rb = self._batches[algo] = RotatingBatch(cq, self.lanes)
        return rb

    @staticmethod
    def _check_algo(algo: str) -> None:
        try:
            get_algebra(algo)
        except ValueError as e:
            raise InvalidRequest(str(e), value=algo) from None

    def _check_src(self, src) -> int:
        if not isinstance(src, (int, np.integer)):
            raise InvalidRequest(
                f"source must be an integer vertex id, got {src!r}",
                value=src)
        if src < 0 or src >= self.graph.n:
            raise InvalidRequest(
                f"source {int(src)} is out of range for this graph "
                f"(|V| = {self.graph.n}; valid ids are 0.."
                f"{self.graph.n - 1})", value=int(src))
        return int(src)

    # ------------------------------------------------------------ #
    def submit(self, algo: str, src: int, *, max_steps: int | None = None,
               deadline_s: float | None = None) -> ServeRequest:
        """Enqueue one query (malformed requests raise `InvalidRequest`
        synchronously; operational rejections come back as a request
        carrying a typed error, exactly the bucket-server contract).

        A result-cache hit completes the request immediately --
        bit-identical attrs and step count to the cold query, zero
        queue wait, zero fixpoint work. Deadlines are measured from
        THIS call on the server's clock, so queue wait consumes them.
        """
        self._check_algo(algo)
        src = self._check_src(src)
        if max_steps is not None and (
                not isinstance(max_steps, (int, np.integer))
                or max_steps < 1):
            raise InvalidRequest(
                f"max_steps must be a positive int, got {max_steps!r}",
                value=max_steps)
        if deadline_s is None:
            deadline_s = self.plan.deadline_s
        if deadline_s is not None and not (
                isinstance(deadline_s, (int, float)) and deadline_s > 0):
            raise InvalidRequest(
                f"deadline_s must be a positive number of seconds, got "
                f"{deadline_s!r}", value=deadline_s)
        now = self.clock.now()
        req = ServeRequest(
            self._next_id, algo, src, t_submit=now,
            max_steps=None if max_steps is None else int(max_steps),
            deadline_s=deadline_s,
            t_deadline=(None if deadline_s is None
                        else now + float(deadline_s)))
        self._next_id += 1
        # cross-query sharing: a converged fixpoint for (fp, algo, src)
        # is immutable for this graph version -- serve it from memory
        entry = self.cache.get(self.graph.fingerprint(), algo, src)
        if entry is not None:
            req.result = entry.attrs
            req.steps = entry.steps
            req.cache_hit = True
            self.metrics.counter("cache.hit").inc()
            self.metrics.counter(f"completed.{algo}").inc()
            self.metrics.histogram(f"latency_s.{algo}").observe(0.0)
            self.completed += 1
            return req
        if self.cache.capacity:
            self.metrics.counter("cache.miss").inc()
        queue = self._queues.setdefault(algo, deque())
        limit = (self.quotas or {}).get(algo, self.max_queue_depth)
        if limit and len(queue) >= limit:
            req.error = CapacityExceeded(
                f"queue for {algo!r} is full ({len(queue)}/{limit}); "
                "request shed (reject-newest)",
                depth=len(queue), limit=limit)
            self.shed += 1
            self.metrics.counter(f"shed.{algo}").inc()
            self.metrics.counter(f"errors.{req.error.code}").inc()
            return req
        queue.append(req)
        return req

    # ------------------------------------------------------------ #
    def pump(self) -> int:
        """One admission window: for every algebra (deterministic
        sorted order) expire dead queued requests, refill idle lanes
        from the queue, then advance the rotating batch by one K-step
        segment and retire what finished. Returns the number of
        requests still pending. An empty pump (nothing queued, nothing
        in flight) is a no-op -- the clock does not advance."""
        with span("flip.pump"):
            for algo in sorted(set(self._queues) | set(self._batches)):
                self._expire_queued(algo)
                self._refill(algo)
                rb = self._batches.get(algo)
                if rb is not None and rb.occupied:
                    self._run_window(algo, rb)
            self._refresh_gauges()
            return self.pending

    def drain(self) -> None:
        """Pump until every submitted request is retired."""
        while self.pending:
            self.pump()

    def serve(self, stream) -> list[ServeRequest]:
        """Run a whole iterable of ``(algo, src)`` queries and
        ``("update", batch)`` mutations; an update drains every query
        submitted before it (they see the pre-update graph) and later
        queries run against the mutated graph -- submission order is
        graph-version order, exactly the bucket-server semantics.

        The scheduler makes progress WHILE the stream arrives: once the
        backlog covers the rotating batch's lanes, each further submit
        pumps one admission window. Early queries therefore retire (and
        populate the result cache) before later repeats of the same
        source are submitted -- the continuous-batching behavior, not
        submit-everything-then-drain."""
        reqs = []
        for algo, arg in stream:
            if algo == "update":
                self.update(arg)
            else:
                reqs.append(self.submit(algo, arg))
                if self.pending >= self.batch:
                    self.pump()
        self.drain()
        return reqs

    # ------------------------------------------------------------ #
    def _expire_queued(self, algo: str) -> None:
        """A request whose deadline passed while queued is retired with
        a typed error and no fixpoint work: queue wait consumed its
        whole budget."""
        queue = self._queues.get(algo)
        if not queue:
            return
        now = self.clock.now()
        live = deque()
        for req in queue:
            if req.t_deadline is not None and req.t_deadline <= now:
                req.queue_wait_s = now - req.t_submit
                req.deadline_expired = True
                req.error = DeadlineExceeded(
                    f"request {req.req_id} ({algo}, src {req.src}) "
                    f"expired after {req.queue_wait_s:.3g}s in queue "
                    f"(deadline {req.deadline_s}s); no work done",
                    deadline_s=req.deadline_s or 0.0,
                    elapsed_s=req.queue_wait_s, where="queue")
                self.failed += 1
                self.metrics.counter(f"errors.{req.error.code}").inc()
                self.metrics.counter(f"expired_in_queue.{algo}").inc()
            else:
                live.append(req)
        self._queues[algo] = live

    def _refill(self, algo: str) -> None:
        """Admit queued queries into idle lanes, FIFO."""
        queue = self._queues.get(algo)
        if not queue:
            return
        rb = self._batch(algo)
        for b in rb.idle:
            if not queue:
                break
            req = queue.popleft()
            req.admit_window = self.windows
            with span("flip.admit", req=req.req_id, algo=algo):
                rb.admit(b, req, self.clock.now(),
                         warm=self._warm_for(req))
            self.metrics.counter(f"admitted.{algo}").inc()
            self.metrics.histogram(f"queue_wait_s.{algo}").observe(
                req.queue_wait_s)

    def _warm_for(self, req: ServeRequest):
        """Warm-start candidate for this (algo, src), if the last
        update left one and its delta is monotone-resumable (exactly
        one graph-version step)."""
        if not self.warm_reuse or req.algo not in self._warm:
            return None
        delta, candidates = self._warm[req.algo]
        attrs = candidates.get(req.src)
        if attrs is None:
            return None
        ws = self._batches[req.algo].engine.resolve_warm(attrs, delta)
        if ws is not None:
            req.warm_started = True
            self.metrics.counter(f"warm_started.{req.algo}").inc()
        return ws

    def _run_window(self, algo: str, rb: RotatingBatch) -> None:
        """One K-step segment plus the retirement pass."""
        occupied = rb.occupied
        try:
            with span("flip.window", algo=algo, lanes=len(occupied)):
                steps, converged, iters = rb.run_window(self.segment_steps)
        except Exception as e:                      # noqa: BLE001
            # typed per-request failure, never a lost bucket: classify,
            # attach, and reset the lanes so the stream keeps serving
            err = classify(e, 0)
            now = self.clock.now()
            for b in occupied:
                req = rb.evict(b)
                req.error = err
                req.service_s = now - rb.t_admit[b]
                self.failed += 1
                self.metrics.counter(f"errors.{err.code}").inc()
            rb.reset()
            return
        self.clock.on_steps(iters)
        self.windows += 1
        self.metrics.counter(f"windows.{algo}").inc()
        self.metrics.histogram("window_iters").observe(iters)
        now = self.clock.now()
        for b in occupied:
            req = rb.slots[b]
            if bool(converged[b]):
                self._retire(rb, b, now, converged=True)
            elif rb.budget_left(b) == 0:
                self._retire(rb, b, now, converged=False,
                             error=ConvergenceFailure(
                                 f"request {req.req_id} ({algo}, src "
                                 f"{req.src}) hit its step budget at "
                                 f"step {req.steps} without converging "
                                 "(partial result attached)",
                                 steps=req.steps,
                                 max_steps=req.max_steps))
            elif req.t_deadline is not None and req.t_deadline <= now:
                req.deadline_expired = True
                self._retire(rb, b, now, converged=False,
                             error=DeadlineExceeded(
                                 f"request {req.req_id} ({algo}, src "
                                 f"{req.src}) stopped at step "
                                 f"{req.steps}: deadline "
                                 f"{req.deadline_s}s expired (partial "
                                 "result attached)",
                                 deadline_s=req.deadline_s or 0.0,
                                 elapsed_s=now - req.t_submit,
                                 where="fixpoint"))

    def _retire(self, rb: RotatingBatch, b: int, now: float, *,
                converged: bool, error=None) -> None:
        """Produce lane `b`'s result (full or flagged partial), attach
        the outcome, free the lane, and feed the cache."""
        req = rb.slots[b]
        with span("flip.retire", req=req.req_id, algo=req.algo):
            req.result = rb.finalize_lane(b)
            req.converged = converged
            req.service_s = now - rb.t_admit[b]
            rb.evict(b)
            m = self.metrics
            if converged:
                self.cache.put(self.graph.fingerprint(), req.algo, req.src,
                               req.result, req.steps)
                self.completed += 1
                m.counter(f"completed.{req.algo}").inc()
            else:
                # a partial is attached AND flagged: the typed error says why
                req.error = error
                self.failed += 1
                m.counter(f"errors.{error.code}").inc()
            m.histogram(f"latency_s.{req.algo}").observe(
                req.queue_wait_s + req.service_s)
            m.histogram(f"service_s.{req.algo}").observe(req.service_s)
            m.histogram(f"steps.{req.algo}").observe(req.steps)

    # ------------------------------------------------------------ #
    def update(self, updates) -> dict:
        """Apply one edge-mutation batch between queries: drain first
        (every submitted query runs against the graph version current
        at its submission), step every session incrementally, retire
        the superseded cache generation into warm-start candidates, and
        reset the rotating batches (all lanes idle on the new version).
        Returns the per-algebra `UpdateDelta`s."""
        self.drain()
        updates = list(updates)
        old_fp = self.graph.fingerprint()
        g2 = self.graph.apply_updates(updates)
        retired = self.cache.retire_fp(old_fp)
        self._warm = {}
        deltas = {}
        for algo, rb in list(self._batches.items()):
            cq2, delta = rb.cq.update(updates, new_graph=g2)
            self._batches[algo] = RotatingBatch(cq2, self.lanes)
            deltas[algo] = delta
            if self.warm_reuse:
                cand = {src: e.attrs for (a, src), e in retired.items()
                        if a == algo}
                if cand:
                    self._warm[algo] = (delta, cand)
        self.graph = g2
        self.updates_applied += 1
        self.metrics.counter("updates.applied").inc()
        return deltas

    # ------------------------------------------------------------ #
    def _refresh_gauges(self) -> None:
        m = self.metrics
        m.gauge("queue_depth").set(
            sum(len(q) for q in self._queues.values()))
        occ = [len(rb.occupied) / rb.nslots
               for rb in self._batches.values()]
        m.gauge("occupancy").set(float(np.mean(occ)) if occ else 0.0)
        m.gauge("cache.hit_rate").set(self.cache.stats()["hit_rate"])

    def stats(self) -> dict:
        """JSON-ready scheduler statistics: queue/occupancy state, the
        cache's hit/eviction ledger, lifetime counters, and the full
        metrics snapshot."""
        self._refresh_gauges()
        snap = self.metrics.snapshot()
        return {
            "scheduler": "continuous",
            "segment_steps": self.segment_steps,
            "queue_depth": int(sum(len(q)
                                   for q in self._queues.values())),
            "queue_depth_per_algo": {a: len(q) for a, q
                                     in self._queues.items() if q},
            "occupancy": snap["gauges"].get("occupancy", 0.0),
            "slots": {a: len(rb.occupied)
                      for a, rb in self._batches.items()},
            "windows": self.windows,
            "cache": self.cache.stats(),
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "updates_applied": self.updates_applied,
            "metrics": snap,
        }
