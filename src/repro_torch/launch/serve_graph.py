"""Graph-query serving front-end: batched multi-query dispatch.

The port of `repro.launch.serve_graph`: the bucket `GraphServer` and its
CLI, on the port's sessions. Sessions run on the CUDA device unless the
server is given ``device="cpu"`` (``--device cpu``); on the card every
dispatch of every ladder rung is launches of the frontier-relax kernel
(see `repro_torch.resilience.degrade` for the card's ladder).

The serving-side counterpart of a batched `CompiledQuery`: a stream of
(algo, src) requests -- multi-source BFS, landmark SSSP, personalized
PageRank probes, ... -- is bucketed by vertex algebra and dispatched in
fixed-size batches, so every dispatch relaxes B independent frontiers
against one shared weight-block stream (the whole batching win) and hits
one cached compiled session per (algebra, graph fingerprint, plan):

  * one `flip_torch.compile` session (block build) per algebra,
    built lazily on first request and reused for the life of the
    server; the cache key is (algebra, graph fingerprint, plan), so a
    wholesale `graph` swap or an out-of-band mutation can never
    silently serve stale results;
  * fixed batch size B (`plan.batch`): partial tail buckets are padded
    by repeating the last source, so every dispatch has the same
    (B, ntiles, T) state shape;
  * per-request results and step counts are returned in submission
    order, exactly equal to what a solo `query(src)` would produce
    (the per-query convergence mask guarantees bit-for-bit equality).

Streaming mutations interleave with queries: `update(batch)` (or an
``("update", batch)`` stream item) drains the pending buckets against
the pre-update graph -- submission order is also graph-version order --
then steps every cached session to the new graph version incrementally
(`CompiledQuery.update`), which re-blocks only the touched tiles.

This module is the synchronous-bucket front-end. The continuous-batching
scheduler (`repro_torch.serving.AsyncGraphServer`: rotating fixpoint
batches, shared result cache, injectable clock) serves the
same streams through the same CLI via ``--scheduler continuous``; both
front-ends return results bit-for-bit equal to solo queries, so the
choice is purely a latency/throughput policy.

CLI demo (synthetic request stream over one dataset graph):

  PYTHONPATH=src python -m repro_torch.launch.serve_graph --dataset LRN \
      --algos bfs,sssp,pagerank --requests 64 --batch 8 --updates 4 \
      --scheduler continuous
  PYTHONPATH=src python -m repro_torch.launch.serve_graph --dataset SRN \
      --algos bfs,sssp --updates 2 --fault-rate 0.25 --check --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch import api as flip
from repro_torch.algebra import ALGEBRAS, get_algebra
from repro_torch.api import CompiledQuery, ExecutionPlan
from repro_torch.distributed.health import HeartbeatMonitor
from repro_torch.graphs import make_dataset, reference
from repro_torch.graphs.csr import Graph
from repro_torch.obs import MetricsRegistry
from repro_torch.resilience import (CapacityExceeded, ConvergenceFailure,
                                    DeadlineExceeded, FaultInjector,
                                    FlipError, InvalidRequest, classify,
                                    fallback_chain, finite_guard)
from repro_torch.serving import AsyncGraphServer


@dataclasses.dataclass
class GraphRequest:
    req_id: int
    algo: str
    src: int
    result: np.ndarray | None = None
    steps: int | None = None
    t_submit: float = 0.0        # perf_counter at enqueue
    queue_wait_s: float = 0.0    # enqueue -> dispatch start
    service_s: float = 0.0       # dispatch wall minus compile share
    # --- resilience surface -------------------------------------- #
    error: FlipError | None = None   # typed failure, if any
    converged: bool = True       # False: `result` is a flagged partial
    deadline_expired: bool = False
    rung: int = 0                # degradation-ladder rung that served it
    max_steps: int | None = None     # per-request step budget
    deadline_s: float | None = None  # per-request budget (relative, as
                                     # given at submit)
    t_deadline: float | None = None  # absolute monotonic deadline

    @property
    def done(self) -> bool:
        """Processed: the server produced a result OR a typed error.
        Every submitted request ends `done` -- nothing is ever lost."""
        return self.result is not None or self.error is not None

    @property
    def ok(self) -> bool:
        """Fully served: converged result, no error."""
        return self.result is not None and self.error is None


@dataclasses.dataclass
class GraphServer:
    """Buckets (algo, src) requests per algebra and dispatches fixed-size
    batches through a compiled-session cache.

    Pass a full `plan` (its `batch` is the serving bucket size), or use
    the per-knob fields (batch/tile/mode/relax_mode/compact) which fold
    into one plan at construction. `device` places every session: the
    CUDA device by default, "cpu" for the plain version."""

    graph: Graph
    batch: int = 8
    tile: int = 128
    mode: str = "data"
    relax_mode: str = "auto"
    compact: bool | str = "auto"  # frontier-compacted block streaming for
                                  # every cached session ('auto' = on for
                                  # data mode); exact, so serving results
                                  # stay bit-for-bit the solo runs
    mapping: object = None       # optional FLIP Mapping: placement-induced
                                 # block sparsity for every cached session
    plan: ExecutionPlan | None = None   # overrides the per-knob fields
    # --- resilience knobs ---------------------------------------- #
    resilience: bool = True      # degradation ladder + finite guard +
                                 # admission control; False = the bare
                                 # dispatch path (the bench A/B baseline)
    max_queue_depth: int = 0     # per-algo queued-request bound
                                 # (0 = unbounded); newest shed first
    quotas: dict | None = None   # per-algo overrides of max_queue_depth
    fault_injector: FaultInjector | None = None  # chaos-test hook
    heartbeat: HeartbeatMonitor | None = None    # beat()s per dispatch
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
        # sessions keyed by (algo, graph fingerprint, plan): stale graph
        # versions can never be served, and updates insert fresh keys
        self._sessions: dict[tuple, CompiledQuery] = {}
        self._buckets: dict[str, list[GraphRequest]] = {}
        self._chains: dict[str, list] = {}   # per-algo degradation ladder
        self._next_id = 0
        self._dispatch_seq = 0   # lifetime bucket-dispatch ordinal (the
                                 # fault injector's pinning axis)
        self.dispatches = 0
        self.completed = 0
        self.failed = 0          # requests finished with a typed error
        self.shed = 0            # requests rejected by admission control
        self.updates_applied = 0
        # per-server metrics: session-cache hit/miss, per-algo latency /
        # queue-wait / service / steps histograms, update+rebuild
        # timings, fallback/shed/error counters
        self.metrics = MetricsRegistry()

    # ------------------------------------------------------------ #
    def session(self, algo: str,
                plan: ExecutionPlan | None = None) -> CompiledQuery:
        """Compiled-session cache: the block build is paid once per
        (algebra, graph fingerprint, plan), then shared
        by every batch. Degradation-ladder rungs pass their own `plan`,
        so fallback sessions coexist with (and never evict) the primary
        for the current graph version."""
        plan = self.plan if plan is None else plan
        fp = self.graph.fingerprint()
        key = (algo, fp, plan.key())
        cq = self._sessions.get(key)
        if cq is None:
            self.metrics.counter("sessions.miss").inc()
            self._check_algo(algo)   # fail fast on unknown algorithms
            # supersede this algebra's sessions for OLDER graph versions
            # only (wholesale swaps would otherwise leak one
            # BlockedGraph per version for the server's lifetime);
            # same-version sessions under other plans are the ladder's
            # fallback rungs and stay hot
            for k in [k for k in self._sessions
                      if k[0] == algo and k[1] != fp]:
                del self._sessions[k]
            t0 = time.perf_counter()
            cq = flip.compile(self.graph, algo, plan,
                              mapping=self.mapping, device=self.device)
            self.metrics.histogram("session_build_s").observe(
                time.perf_counter() - t0)
            self._sessions[key] = cq
        else:
            self.metrics.counter("sessions.hit").inc()
        return cq

    def engine(self, algo: str):
        """The FlipEngine behind this algebra's cached session (legacy
        accessor; prefer `session`)."""
        return self.session(algo).engine

    @staticmethod
    def _check_algo(algo: str) -> None:
        """Unknown algorithms are an `InvalidRequest` (still a
        ValueError, so pre-taxonomy call sites keep working)."""
        try:
            get_algebra(algo)
        except ValueError as e:
            raise InvalidRequest(str(e), value=algo) from None

    # ------------------------------------------------------------ #
    def update(self, updates) -> dict:
        """Apply one edge-mutation batch between queries.

        Pending buckets are drained first, so every already-submitted
        query runs against the graph version current at its submission.
        Each cached session is then stepped to the new graph version
        incrementally (`CompiledQuery.update`): only the touched tiles
        are recomputed. Returns the per-algebra `UpdateDelta`s."""
        self.drain()
        t0 = time.perf_counter()
        updates = list(updates)    # consumed once per cached session
        g2 = self.graph.apply_updates(updates)
        old_fp, pk = self.graph.fingerprint(), self.plan.key()
        deltas = {}
        for (algo, fp, k), cq in list(self._sessions.items()):
            if fp != old_fp:
                del self._sessions[(algo, fp, k)]   # prune stale versions
                continue
            # step EVERY current-version session -- the primary plan and
            # any degradation-ladder rungs alike -- so a post-update
            # fallback can never serve the pre-update graph
            tr = time.perf_counter()
            cq2, delta = cq.update(updates, new_graph=g2)
            self.metrics.histogram("rebuild_s").observe(
                time.perf_counter() - tr)
            del self._sessions[(algo, fp, k)]
            self._sessions[(algo, g2.fingerprint(), k)] = cq2
            if k == pk or algo not in deltas:
                deltas[algo] = delta
        self.graph = g2
        self.updates_applied += 1
        self.metrics.histogram("update_s").observe(time.perf_counter() - t0)
        self.metrics.counter("updates.applied").inc()
        return deltas

    # ------------------------------------------------------------ #
    def submit(self, algo: str, src: int, *, max_steps: int | None = None,
               deadline_s: float | None = None) -> GraphRequest:
        """Enqueue one query; a full bucket dispatches immediately.

        Malformed requests (unknown algorithm, out-of-range source, bad
        budget) raise `InvalidRequest` here, synchronously -- a caller
        bug should fail the call, not poison a batch. Operational
        rejections (admission control) instead come back as a request
        carrying a typed `CapacityExceeded` error: the stream survives,
        the caller sees exactly which request was shed.

        max_steps  -- per-request fixpoint step budget (partial results
                      come back flagged `converged=False`).
        deadline_s -- per-request wall-clock budget, measured from THIS
                      call (queue wait counts); default plan.deadline_s.
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
        req = GraphRequest(
            self._next_id, algo, int(src), t_submit=time.perf_counter(),
            max_steps=None if max_steps is None else int(max_steps),
            deadline_s=deadline_s,
            t_deadline=(None if deadline_s is None
                        else time.monotonic() + float(deadline_s)))
        self._next_id += 1
        bucket = self._buckets.setdefault(algo, [])
        limit = ((self.quotas or {}).get(algo, self.max_queue_depth)
                 if self.resilience else 0)
        if limit and len(bucket) >= limit:
            # reject-newest: accepted requests keep their latency; the
            # shed request is returned processed (typed error), never
            # silently dropped
            req.error = CapacityExceeded(
                f"queue for {algo!r} is full ({len(bucket)}/{limit}); "
                "request shed (reject-newest)",
                depth=len(bucket), limit=limit)
            self.shed += 1
            self.metrics.counter(f"shed.{algo}").inc()
            self.metrics.counter(
                f"errors.{req.error.code}").inc()
            return req
        bucket.append(req)
        if len(bucket) >= self.batch:
            self._dispatch(algo)
        return req

    def _check_src(self, src) -> int:
        """Source range check at the admission edge: a negative id would
        silently gather from the end of the attr arrays; an id >= |V|
        would index past the state tensors."""
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

    def drain(self) -> None:
        """Flush every partial bucket (tail of the request stream)."""
        for algo in list(self._buckets):
            if self._buckets[algo]:
                self._dispatch(algo)

    def serve(self, stream) -> list[GraphRequest]:
        """Convenience: run a whole iterable of requests and return the
        queries completed, in submission order. Items are ``(algo, src)``
        queries or ``("update", batch)`` mutations; an update drains the
        queries submitted before it (they see the pre-update graph) and
        every later query runs against the mutated graph."""
        reqs = []
        for algo, arg in stream:
            if algo == "update":
                self.update(arg)
            else:
                reqs.append(self.submit(algo, arg))
        self.drain()
        return reqs

    # ------------------------------------------------------------ #
    def _ladder(self, algo: str) -> list:
        """The degradation ladder for this server's plan: rung 0 is the
        primary plan AS CONFIGURED (so it hits the same session-cache
        key the non-resilient path uses), later rungs come from
        `fallback_chain` (relax_mode -> 'torch', then compact -> False,
        resolved for the server's device; every rung exact and
        pre-validated). Cached per algebra."""
        chain = self._chains.get(algo)
        if chain is None:
            resolved = fallback_chain(self.plan, get_algebra(algo),
                                      self.device)
            chain = [self.plan] + resolved[1:]
            self._chains[algo] = chain
        return chain

    def _remaining(self, reqs) -> list | None:
        """Per-request deadline budget left, relative to now (the
        session API takes relative deadlines; the request stores the
        absolute one, so queue wait and ladder retries consume it).
        Expired-in-queue entries clamp to an epsilon: the engine then
        stops them at step 0 and flags `deadline_expired` -- same code
        path as a mid-fixpoint expiry."""
        if all(r.t_deadline is None for r in reqs):
            return None
        now = time.monotonic()
        return [None if r.t_deadline is None
                else max(r.t_deadline - now, 1e-9) for r in reqs]

    def _run_ladder(self, algo: str, reqs: list, dispatch_id: int):
        """One bucket through the engine, retried once per ladder rung
        on retryable failure. Returns ``(QueryResult, attrs, rung)`` of
        the first rung that served, or raises the last typed error."""
        srcs = np.asarray([r.src for r in reqs])
        budgets = None
        if any(r.max_steps is not None for r in reqs):
            budgets = [self.plan.max_steps if r.max_steps is None
                       else r.max_steps for r in reqs]
        plans = self._ladder(algo) if self.resilience else [self.plan]
        err = None
        for rung, plan in enumerate(plans):
            if self.heartbeat is not None:
                self.heartbeat.beat()
            try:
                if self.fault_injector is not None:
                    self.fault_injector.before_dispatch(
                        algo, dispatch_id, rung)
                res = self.session(algo, plan).query(
                    srcs, max_steps=budgets,
                    deadline_s=self._remaining(reqs))
                # fixpoint iterations of every engine run, retries
                # included: on the card, the relax kernel's launches
                self.metrics.histogram("dispatch_iters").observe(
                    int(np.max(res.steps)))
                attrs = np.asarray(res.attrs)
                if self.fault_injector is not None:
                    attrs = self.fault_injector.after_dispatch(
                        algo, dispatch_id, rung, attrs)
                if self.resilience:
                    finite_guard(attrs)
                if self.heartbeat is not None:
                    self.heartbeat.beat()    # re-arm after a stall
                if rung:
                    self.metrics.counter(f"fallback.{algo}").inc()
                    self.metrics.counter(f"fallback_rung.{rung}").inc()
                return res, attrs, rung
            except Exception as e:              # noqa: BLE001
                err = classify(e, rung)
                self.metrics.counter(
                    f"dispatch_errors.{err.code}").inc()
                if not (self.resilience and err.retryable
                        and rung + 1 < len(plans)):
                    raise err from getattr(err, "cause", None)
                self.metrics.histogram("fallback_retry_s").observe(
                    time.perf_counter() - reqs[0].t_submit)
        raise err                                # pragma: no cover

    def _dispatch(self, algo: str) -> None:
        """Dispatch one bucket with per-request failure isolation.

        The bucket stays queued until the dispatch has an outcome for
        every request: success attaches results, ladder exhaustion
        attaches the typed error to each request individually -- a
        failure can never lose requests or take down the stream."""
        reqs = self._buckets.get(algo) or []
        if not reqs:
            return
        dispatch_id = self._dispatch_seq
        self._dispatch_seq += 1
        t_start = time.perf_counter()
        m = self.metrics
        try:
            res, attrs, rung = self._run_ladder(algo, reqs, dispatch_id)
        except FlipError as e:
            # ladder exhausted (or non-retryable): fail THIS bucket's
            # requests individually; server and stream keep serving
            self._buckets[algo] = []
            service = time.perf_counter() - t_start
            for req in reqs:
                req.error = e
                req.queue_wait_s = t_start - req.t_submit
                req.service_s = service
                m.counter(f"errors.{e.code}").inc()
            m.counter(f"failed.{algo}").inc(len(reqs))
            self.failed += len(reqs)
            return
        self._buckets[algo] = []
        t_done = time.perf_counter()
        # queue-wait vs service split: waiting is per request (enqueue ->
        # dispatch start); service is the dispatch wall shared by the
        # bucket, with the first-dispatch compile share carved out so the
        # latency histograms describe steady-state serving
        service = (t_done - t_start) - res.compile_s
        conv = np.broadcast_to(np.atleast_1d(res.converged), (len(reqs),))
        exp = np.broadcast_to(np.atleast_1d(res.deadline_expired),
                              (len(reqs),))
        for b, req in enumerate(reqs):
            req.result = attrs[b]
            req.steps = int(res.steps[b])
            req.rung = rung
            req.converged = bool(conv[b])
            req.deadline_expired = bool(exp[b])
            req.queue_wait_s = t_start - req.t_submit
            req.service_s = service
            if not req.converged:
                # partial result: typed error says WHY it is partial
                if req.deadline_expired:
                    req.error = DeadlineExceeded(
                        f"request {req.req_id} ({algo}, src {req.src}) "
                        f"stopped at step {req.steps}: deadline "
                        f"{req.deadline_s}s expired (partial result "
                        "attached)", deadline_s=req.deadline_s or 0.0,
                        elapsed_s=req.queue_wait_s + service)
                else:
                    req.error = ConvergenceFailure(
                        f"request {req.req_id} ({algo}, src {req.src}) "
                        f"hit its step budget at step {req.steps} "
                        "without converging (partial result attached)",
                        steps=req.steps, max_steps=req.max_steps)
                m.counter(f"errors.{req.error.code}").inc()
                self.failed += 1
            m.histogram(f"latency_s.{algo}").observe(
                req.queue_wait_s + service)
            m.histogram(f"queue_wait_s.{algo}").observe(req.queue_wait_s)
            m.histogram(f"service_s.{algo}").observe(service)
            m.histogram(f"steps.{algo}").observe(req.steps)
        if res.compile_s:
            m.histogram("compile_s").observe(res.compile_s)
        m.counter(f"dispatches.{algo}").inc(res.dispatches)
        m.counter("requests.completed").inc(len(reqs))
        self.dispatches += res.dispatches
        self.completed += len(reqs)

    # ------------------------------------------------------------ #
    def stats(self) -> dict:
        """JSON-ready server statistics: queue state, session-cache
        hit/miss, lifetime counters, and the full metrics snapshot
        (per-algo latency / queue-wait / service / steps histograms,
        update and rebuild timings, compile-time histogram)."""
        snap = self.metrics.snapshot()
        queue = {algo: len(b) for algo, b in self._buckets.items() if b}
        return {
            "queue_depth": int(sum(queue.values())),
            "queue_depth_per_algo": queue,
            "sessions_cached": len(self._sessions),
            "session_cache": {
                "hits": snap["counters"].get("sessions.hit", 0),
                "misses": snap["counters"].get("sessions.miss", 0),
            },
            "completed": self.completed,
            "failed": self.failed,
            "shed": self.shed,
            "dispatches": self.dispatches,
            "updates_applied": self.updates_applied,
            "resilience": {
                "enabled": self.resilience,
                "fallbacks": self.metrics.sum_counters("fallback."),
                "shed": self.metrics.sum_counters("shed."),
                "errors": self.metrics.sum_counters("errors."),
                "dispatch_errors":
                    self.metrics.sum_counters("dispatch_errors."),
                "heartbeat_stalls": (0 if self.heartbeat is None
                                     else self.heartbeat.stall_count),
                "faults_fired": (0 if self.fault_injector is None
                                 else len(self.fault_injector.fired)),
            },
            "metrics": snap,
        }


# ----------------------------------------------------------------- #
# CLI demo: synthetic request stream over one Table-4 dataset graph
# ----------------------------------------------------------------- #
def _random_update_batch(g, rng, k: int = 4):
    """Small mutation batch for the demo stream: ⊕-improving reweights
    (halved weights) of k random existing edges plus one random insert."""
    eu = g.edge_sources()
    idx = rng.choice(g.m, size=min(k, g.m), replace=False)
    batch = [(int(eu[i]), int(g.indices[i]), float(g.weights[i]) * 0.5)
             for i in idx]
    batch.append((int(rng.integers(g.n)), int(rng.integers(g.n)),
                  float(rng.integers(1, 9))))
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="LRN",
                    choices=["Tree", "SRN", "LRN", "Syn", "ExtLRN"])
    ap.add_argument("--graph-seed", type=int, default=0)
    ap.add_argument("--algos", default="bfs,sssp,pagerank",
                    help="comma list of registered algebras to sample")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--updates", type=int, default=0,
                    help="interleave this many random edge-update batches "
                         "into the stream; queries after an update run "
                         "against the mutated graph")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--mode", default="data", choices=["data", "op"])
    ap.add_argument("--compact", default="auto",
                    choices=["auto", "on", "off"],
                    help="frontier-compacted block streaming (auto = on "
                         "for data mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="bucket",
                    choices=["bucket", "continuous"],
                    help="'bucket': synchronous fixed-size buckets "
                         "(this module); 'continuous': the rotating-"
                         "batch scheduler with a shared result cache "
                         "(repro_torch.serving) -- results are "
                         "bit-identical either way")
    ap.add_argument("--segment-steps", type=int, default=4,
                    help="continuous scheduler only: fixpoint steps per "
                         "admission window (K); converged queries retire "
                         "and queued ones are admitted every K steps")
    ap.add_argument("--cache-capacity", type=int, default=256,
                    help="continuous scheduler only: shared result-cache "
                         "entries (0 disables cross-query sharing)")
    ap.add_argument("--no-resilience", action="store_true",
                    help="disable the degradation ladder / finite guard "
                         "/ admission control (the bare dispatch path)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="per-algo queued-request bound (0 = unbounded); "
                         "newest requests are shed with a typed "
                         "CapacityExceeded")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="per-request fixpoint step budget (partials "
                         "come back flagged, with a typed error)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget in seconds")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos demo: inject seeded faults (backend "
                         "raise / NaN poison) into this fraction of "
                         "dispatches; the ladder must absorb them")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="verify every successful response against the "
                         "numpy oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch version)")
    ap.add_argument("--stats", action="store_true",
                    help="print the server stats() JSON (queue depth, "
                         "session-cache hit/miss, per-algo latency "
                         "histograms, update timings) after the stream")
    args = ap.parse_args(argv)

    algos = [a.strip() for a in args.algos.split(",") if a.strip()]
    for a in algos:
        get_algebra(a)
    g = next(make_dataset(args.dataset, 1, seed0=args.graph_seed))
    print(f"[serve] {args.dataset}: |V|={g.n} |E|={g.m} "
          f"algos={algos} B={args.batch}")

    rng = np.random.default_rng(args.seed)
    # interleave update batches at evenly spaced stream positions; track
    # the graph version each query will be dispatched against so --check
    # verifies every response against the right oracle snapshot
    update_at = (set(np.linspace(1, args.requests - 1, args.updates,
                                 dtype=int).tolist())
                 if args.updates else set())
    stream, snapshots, g_cur = [], [], g
    for i in range(args.requests):
        if i in update_at:
            batch = _random_update_batch(g_cur, rng)
            stream.append(("update", batch))
            g_cur = g_cur.apply_updates(batch)
        stream.append((algos[int(rng.integers(len(algos)))],
                       int(rng.integers(g.n))))
        snapshots.append(g_cur)

    compact = {"auto": "auto", "on": True, "off": False}[args.compact]
    plan = ExecutionPlan(mode=args.mode, compact=compact, tile=args.tile,
                         batch=args.batch, deadline_s=args.deadline_s)
    injector = (FaultInjector.random(args.fault_seed, args.requests,
                                     algos=algos, rate=args.fault_rate)
                if args.fault_rate > 0 else None)
    if args.scheduler == "continuous":
        if injector is not None:
            raise SystemExit("--fault-rate drives the bucket server's "
                             "dispatch hook; use --scheduler bucket "
                             "for the chaos demo")
        srv = AsyncGraphServer(g, plan=plan,
                               segment_steps=args.segment_steps,
                               cache_capacity=args.cache_capacity,
                               max_queue_depth=args.max_queue_depth,
                               device=args.device)
    else:
        srv = GraphServer(g, plan=plan,
                          resilience=not args.no_resilience,
                          max_queue_depth=args.max_queue_depth,
                          fault_injector=injector, device=args.device)
    for a in algos:                      # build/compile outside the clock
        srv.session(a)
    submit_kw = {} if args.max_steps is None \
        else {"max_steps": args.max_steps}
    t0 = time.time()
    reqs = []
    for algo, arg in stream:
        if algo == "update":
            srv.update(arg)
        else:
            reqs.append(srv.submit(algo, arg, **submit_kw))
    srv.drain()
    wall = time.time() - t0
    assert all(r.done for r in reqs), "server lost requests"
    n_ok = sum(r.ok for r in reqs)
    if args.scheduler == "continuous":
        cache = srv.cache.stats()
        print(f"[serve] {len(reqs)} requests in {wall:.2f}s "
              f"({len(reqs) / wall:.1f} req/s) over {srv.windows} "
              f"admission windows of K={args.segment_steps} on "
              f"B={args.batch} lanes, {srv.updates_applied} update "
              f"batches applied; {n_ok} ok, {srv.failed} failed "
              f"(typed), {srv.shed} shed; cache hit rate "
              f"{cache['hit_rate']:.0%} ({cache['hits']} hits)")
    else:
        print(f"[serve] {len(reqs)} requests in {wall:.2f}s "
              f"({len(reqs) / wall:.1f} req/s) over {srv.dispatches} "
              f"dispatches of B={args.batch}, {srv.updates_applied} "
              f"update batches applied; {n_ok} ok, {srv.failed} failed "
              f"(typed), {srv.shed} shed, "
              f"{srv.metrics.sum_counters('fallback.')} fallbacks")
    if args.stats:
        print(json.dumps(srv.stats(), indent=2, sort_keys=True))
    if args.check:
        bad = 0
        checked = 0
        for r, g_snap in zip(reqs, snapshots):
            if not r.ok:
                continue                 # typed failure, not a result
            checked += 1
            ref, _ = reference.run(r.algo, g_snap, r.src)
            bad += not ALGEBRAS[r.algo].results_match(r.result, ref)
        print(f"[serve] oracle check: {checked - bad}/{checked} correct "
              f"({len(reqs) - checked} failed requests excluded)")
        if bad:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
