"""The compile-then-query session: `flip_torch.compile(graph, program, plan)`.

The port of `repro.api.session`:

    import flip_torch

    cq = flip_torch.compile(graph, "sssp")        # on the CUDA device
    r = cq.query(5)                               # scalar -> (n,) attrs
    rb = cq.query([0, 5, 9])                      # batch  -> (B, n)
    assert r.check()                              # vs the numpy oracle

    cq2, delta = cq.update(edge_batch)            # streaming mutation
    r2 = cq2.query(5, warm=r)                     # incremental recompute
    rt = cq.query(5, trace=True)                  # rt.telemetry: per step

`query` handles scalar, batched, bucketed (plan.batch > 0), incremental
(warm=) and traced (trace=) execution; the plan decides *how*, never
*what*. A session runs on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit device, `compile`
raises instead of quietly running on the CPU. Sessions are immutable
snapshots of one graph version: `update` returns a new one.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.program import Program
from repro_torch.core.engine import FlipEngine, WarmStart
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.frontier.ops import UpdateDelta
from repro_torch.obs.telemetry import QueryTelemetry
from repro_torch.resilience.errors import ConvergenceFailure, InvalidRequest


@dataclasses.dataclass
class QueryResult:
    """One query's outcome: attrs in original vertex order ((n,) for a
    scalar source, (B, n) for a batch), per-query relaxation step counts
    (int / (B,) to match), the sources as queried, the resolved plan,
    and wall seconds. Usable as the `warm=` argument of a post-update
    `query` call.

    `compile_s` is the share of `wall_s` spent in the first dispatch of
    each signature (solo / batch-of-B, traced or not) the session has
    run: on the card that dispatch builds or loads the kernel, so
    steady-state latency reads ``wall_s - compile_s``. `telemetry` is
    set iff the query ran with ``trace=``: per-dispatch, per-step
    frontier records (see `repro_torch.obs`).

    `converged` (bool, or (B,)) is the engine's per-query convergence
    mask: False means the query was stopped by a `max_steps` /
    `deadline_s` budget or by `plan.max_steps`, and its attrs row is a
    flagged partial relaxation. `deadline_expired` marks which of those
    stops were the deadline's."""

    attrs: np.ndarray
    steps: int | np.ndarray
    srcs: int | np.ndarray
    plan: ExecutionPlan
    program: Program
    graph: Graph
    wall_s: float = 0.0
    dispatches: int = 1
    compile_s: float = 0.0
    telemetry: QueryTelemetry | None = None
    converged: bool | np.ndarray = True
    deadline_expired: bool | np.ndarray = False

    @property
    def batched(self) -> bool:
        return bool(np.ndim(self.srcs))

    @property
    def all_converged(self) -> bool:
        return bool(np.all(self.converged))

    def check(self) -> bool:
        """Verify every row against the program's numpy oracle at the
        algebra's tolerance. Raises `ConvergenceFailure` if any query hit
        its step/deadline budget: a truncated fixpoint cannot be
        oracle-checked."""
        if not self.all_converged:
            conv = np.atleast_1d(np.asarray(self.converged))
            bad = np.flatnonzero(~conv)
            raise ConvergenceFailure(
                f"cannot oracle-check a non-converged result: "
                f"quer{'y' if bad.size == 1 else 'ies'} "
                f"{bad.tolist()} stopped at "
                f"{np.atleast_1d(np.asarray(self.steps))[bad].tolist()} "
                "steps with a non-empty frontier (step/deadline budget "
                f"or plan.max_steps={self.plan.max_steps} hit)",
                steps=self.steps, max_steps=self.plan.max_steps)
        if not self.batched:
            return self.program.check(self.graph, int(self.srcs),
                                      self.attrs)
        return all(self.program.check(self.graph, int(s), self.attrs[b])
                   for b, s in enumerate(np.asarray(self.srcs)))


@dataclasses.dataclass
class CompiledQuery:
    """A compiled (graph, program, plan) session on one device. Create
    via `compile`; `plan` is already resolved (no 'auto' left)."""

    graph: Graph
    program: Program
    plan: ExecutionPlan
    engine: FlipEngine
    tune: object = None                # TuneReport when compiled with a
                                       # tuned=True plan (why the knobs
                                       # are what they are)
    delta: UpdateDelta | None = None   # set by update(): the last batch
    prev_fp: str | None = None         # fingerprint of the pre-update
                                       # graph the delta resumes from
    # dispatch signatures this session has run; a signature's first
    # dispatch is attributed to QueryResult.compile_s. Shared across
    # update()-derived sessions (the kernel stays loaded).
    _dispatched: set = dataclasses.field(default_factory=set, repr=False)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def query(self, srcs, *, warm=None, trace: bool | int = False,
              max_steps=None, deadline_s=None) -> QueryResult:
        """Run the program from `srcs` under the session's plan.

        srcs       -- one source vertex (scalar result shapes) or a
                      sequence of B sources (batched shapes). With
                      plan.batch = B > 0 a sequence dispatches in padded
                      fixed-size buckets of B. Out-of-range ids raise
                      `InvalidRequest`.
        warm       -- resume from a prior converged result: a
                      `QueryResult` for the same sources on the
                      pre-update session (the session's last `update`
                      delta decides soundness under plan.warm), or an
                      explicit `WarmStart`.
        trace      -- per-step frontier tracing: True, or an int row
                      capacity. The result's `telemetry` then holds one
                      `DispatchTelemetry` per dispatch. Exact: attrs and
                      steps are bit-identical to the untraced run.
        max_steps  -- per-request step budget (int, or one per source),
                      clipped to plan.max_steps; a query it stops comes
                      back with ``converged`` False.
        deadline_s -- per-request wall-clock budget in seconds from this
                      call (default plan.deadline_s), enforced at step
                      boundaries; `deadline_expired` marks queries it
                      stopped.
        """
        t0 = time.perf_counter()
        self._validate_srcs(srcs)
        if deadline_s is None:
            deadline_s = self.plan.deadline_s
        batched = bool(np.ndim(srcs))
        b = len(np.atleast_1d(srcs)) if batched else 1
        budgets = self._per_query(max_steps, b, "max_steps",
                                  dtype=np.int64, minimum=1,
                                  none_fill=self.plan.max_steps)
        # deadlines become absolute at the query's start, so a bucketed
        # query's later chunks see the *remaining* budget, not a fresh one
        rel = self._per_query(deadline_s, b, "deadline_s",
                              dtype=np.float64, minimum=0.0,
                              exclusive=True)
        deadline_abs = (None if rel is None
                        else time.monotonic() + np.where(
                            np.isnan(rel), np.inf, rel))
        if batched and b == 0:
            d = self.plan.feature_dim
            shape = (0, self.graph.n, d) if d > 1 else (0, self.graph.n)
            return QueryResult(
                attrs=np.zeros(shape, dtype=np.float32),
                steps=np.zeros(0, dtype=np.int32),
                srcs=np.zeros(0, dtype=np.int64), plan=self.plan,
                program=self.program, graph=self.graph,
                wall_s=time.perf_counter() - t0, dispatches=0,
                converged=np.ones(0, dtype=bool),
                deadline_expired=np.zeros(0, dtype=bool),
                telemetry=QueryTelemetry([]) if trace else None)
        ws = self._resolve_warm(warm, srcs)
        teles: list = []
        if not batched or self.plan.batch == 0:
            det, wall, first = self._dispatch(srcs, ws, trace, budgets,
                                              deadline_abs)
            out, steps = det.attrs, det.steps
            conv, expired = det.converged, det.deadline_expired
            dispatches = 1
            compile_s = wall if first else 0.0
            if det.telemetry is not None:
                teles.append(det.telemetry)
        else:
            (out, steps, conv, expired, dispatches, teles, compile_s) = \
                self._query_bucketed(
                    np.atleast_1d(np.asarray(srcs, dtype=np.int64)),
                    ws, trace, budgets, deadline_abs)
        wall_s = time.perf_counter() - t0
        telemetry = None
        if trace:
            if self.tune is not None:
                # tuned sessions stamp their provenance on every
                # dispatch record: which knobs the tuner chose and why
                stamp = {
                    "chosen": {"tile": self.plan.tile,
                               "relax_mode": self.plan.relax_mode,
                               "compact": self.plan.compact,
                               "batch": self.plan.batch},
                    "why": self.tune.why,
                    "cached": self.tune.cached,
                    "fingerprint": self.tune.profile.fingerprint(),
                }
                for t in teles:
                    t.meta["autotune"] = stamp
            telemetry = QueryTelemetry(dispatches=teles, wall_s=wall_s,
                                       compile_s=compile_s)
        return QueryResult(attrs=out, steps=steps,
                           srcs=(np.asarray(srcs) if batched
                                 else int(srcs)),
                           plan=self.plan, program=self.program,
                           graph=self.graph, wall_s=wall_s,
                           dispatches=dispatches, compile_s=compile_s,
                           telemetry=telemetry, converged=conv,
                           deadline_expired=expired)

    def validate_sources(self, srcs) -> None:
        """Public admission-edge check: raise `InvalidRequest` unless
        every id in `srcs` is a vertex of this session's graph -- the
        check `query` applies, for callers that queue requests first."""
        self._validate_srcs(srcs)

    def _validate_srcs(self, srcs) -> None:
        a = np.atleast_1d(np.asarray(srcs))
        if a.size == 0:
            return
        if not np.issubdtype(a.dtype, np.integer):
            cast = a.astype(np.int64, casting="unsafe")
            if not np.array_equal(cast, a):
                raise InvalidRequest(
                    f"sources must be integer vertex ids, got dtype "
                    f"{a.dtype}", value=srcs)
            a = cast
        bad = (a < 0) | (a >= self.graph.n)
        if bad.any():
            v = int(a[bad][0])
            raise InvalidRequest(
                f"source {v} is out of range for this graph "
                f"(|V| = {self.graph.n}; valid ids are 0.."
                f"{self.graph.n - 1})", value=v)

    @staticmethod
    def _per_query(val, b: int, name: str, dtype, minimum,
                   exclusive: bool = False, none_fill=np.nan):
        """Broadcast a scalar-or-per-source budget to (b,), validating
        type and range. None entries take the default (`none_fill`)."""
        if val is None:
            return None
        arr = np.atleast_1d(np.asarray(
            [none_fill if v is None else v for v in np.atleast_1d(val)]))
        raw = arr
        try:
            arr = arr.astype(dtype)
        except (TypeError, ValueError):
            raise InvalidRequest(
                f"{name} must be numeric, got {val!r}", value=val)
        if np.issubdtype(dtype, np.integer) and not np.array_equal(
                arr.astype(np.float64), raw.astype(np.float64)):
            raise InvalidRequest(
                f"{name} must be whole numbers, got {val!r}", value=val)
        if arr.shape not in ((1,), (b,)):
            raise InvalidRequest(
                f"{name} has {arr.shape[0]} entries for {b} sources "
                "(pass a scalar or one per source)", value=val)
        finite = arr[~np.isnan(arr.astype(np.float64))]
        low = (finite <= minimum) if exclusive else (finite < minimum)
        if low.any():
            raise InvalidRequest(
                f"{name} must be {'>' if exclusive else '>='} "
                f"{minimum}, got {finite[low][0]}", value=val)
        return np.broadcast_to(arr, (b,))

    def _dispatch(self, srcs, ws, trace, budgets=None, deadline_abs=None):
        """One engine dispatch: returns ``(ExecutionDetail, wall_s,
        first)`` where `first` marks the first dispatch of this
        signature."""
        sig = ("solo" if not np.ndim(srcs) else len(srcs), bool(trace))
        first = sig not in self._dispatched
        remaining = (None if deadline_abs is None
                     else np.asarray(deadline_abs) - time.monotonic())
        t0 = time.perf_counter()
        det = self.engine.execute(srcs, warm=ws, trace=trace,
                                  max_steps=budgets, deadline_s=remaining,
                                  detail=True)
        wall = time.perf_counter() - t0
        self._dispatched.add(sig)
        if det.telemetry is not None:
            det.telemetry.wall_s = wall
        return det, wall, first

    def _query_bucketed(self, srcs, ws, trace, budgets=None,
                        deadline_abs=None):
        """plan.batch-sized dispatch: pad the tail bucket by repeating
        its last source (budgets, deadlines and per-query warm rows pad
        along with it) so every dispatch has one (B, ntiles, T) shape,
        then drop the padded rows."""
        nb = self.plan.batch
        outs, steps, convs, exps, teles = [], [], [], [], []
        compile_s = 0.0

        def pad(arr, i, k):
            if arr is None:
                return None
            chunk = np.asarray(arr)[i:i + k]
            return np.concatenate([chunk, np.repeat(chunk[-1:], nb - k)])

        for i in range(0, len(srcs), nb):
            k = len(srcs[i:i + nb])
            det, wall, first = self._dispatch(
                pad(srcs, i, k), self._slice_warm(ws, i, k, nb), trace,
                pad(budgets, i, k), pad(deadline_abs, i, k))
            if first:
                compile_s += wall
            if det.telemetry is not None:
                teles.append(det.telemetry)
            outs.append(det.attrs[:k])
            steps.append(det.steps[:k])
            convs.append(np.atleast_1d(det.converged)[:k])
            exps.append(np.atleast_1d(det.deadline_expired)[:k])
        return (np.concatenate(outs), np.concatenate(steps),
                np.concatenate(convs), np.concatenate(exps), len(outs),
                teles, compile_s)

    def _slice_warm(self, ws, i, k, nb):
        """Per-bucket view of a warm start: batch-shared warm attrs
        ((n,), or (n, d) at feature_dim d > 1) go to every bucket;
        per-query warm attrs ((B, n[, d])) follow their queries, padded
        by repeating the chunk's last row like the sources."""
        shared_ndim = 2 if self.plan.feature_dim > 1 else 1
        if ws is None or np.ndim(ws.attrs) == shared_ndim:
            return ws
        rows = np.asarray(ws.attrs)[i:i + k]
        rows = np.concatenate([rows, np.repeat(rows[-1:], nb - k, axis=0)])
        return WarmStart(attrs=rows, seeds=ws.seeds)

    def _resolve_warm(self, warm, srcs) -> WarmStart | None:
        """Apply the plan's warm policy to the caller's `warm`."""
        if warm is None:
            return None
        if self.plan.warm == "never":
            raise ValueError(
                "this session's plan has warm='never'; query(warm=...) "
                "is forbidden -- recompute from scratch or compile with "
                "warm='auto'")
        if isinstance(warm, WarmStart):
            return warm
        if isinstance(warm, QueryResult):
            qs = np.atleast_1d(np.asarray(srcs, dtype=np.int64))
            wsrc = np.atleast_1d(np.asarray(warm.srcs, dtype=np.int64))
            # a converged result only resumes *its own* sources; a
            # scalar-source result may fan out over a batch of it
            if not ((wsrc.shape == qs.shape and np.array_equal(wsrc, qs))
                    or (wsrc.size == 1 and bool(np.all(qs == wsrc[0])))):
                raise ValueError(
                    f"warm result was computed for sources "
                    f"{wsrc.tolist()} but this query asks for "
                    f"{qs.tolist()}; a warm start only resumes the "
                    "same sources")
            if self.delta is None:
                raise ValueError(
                    "query(warm=QueryResult) resumes across an update: "
                    "this session has no update delta (create it with "
                    "session.update(...)); pass an explicit WarmStart "
                    "to resume from arbitrary state")
            attrs = np.asarray(warm.attrs)
            batched_ndim = 3 if self.plan.feature_dim > 1 else 2
            if wsrc.size == 1 and attrs.ndim == batched_ndim \
                    and qs.shape != wsrc.shape:
                attrs = attrs[0]      # (1, n[, d]) fans out like (n[, d])
            if warm.graph.fingerprint() != self.prev_fp:
                # the delta's seeds only cover the *last* batch
                raise ValueError(
                    "warm result was not computed on this session's "
                    "pre-update graph version; re-query each version "
                    "(warm results are valid across exactly one "
                    "update), or pass an explicit WarmStart")
            ws = self.engine.resolve_warm(attrs, self.delta)
            if ws is None and self.plan.warm == "always":
                raise ValueError(
                    f"plan.warm='always' but the last update batch is "
                    f"not monotone under {self.program.name}'s ⊕ (or "
                    "the algebra is not monotone): incremental "
                    "recompute would be unsound")
            return ws
        raise TypeError(
            f"warm must be a QueryResult or WarmStart, got "
            f"{type(warm).__name__}")

    # -------------------------------------------------------------- #
    def update(self, updates, new_graph: Graph | None = None) \
            -> tuple["CompiledQuery", UpdateDelta]:
        """Streaming graph mutation: apply one edge-update batch and
        return ``(new_session, delta)``. The new session re-blocks only
        the touched tiles and remembers `delta`, so a later
        ``query(src, warm=prev_result)`` resumes incrementally exactly
        when sound. This session is left untouched."""
        updates = list(updates)      # consumed twice (graph + engine)
        g2 = (self.graph.apply_updates(updates) if new_graph is None
              else new_graph)
        eng2, delta = self.engine.apply_updates(g2, updates)
        return dataclasses.replace(
            self, graph=g2, engine=eng2, delta=delta,
            prev_fp=self.graph.fingerprint()), delta


# ------------------------------------------------------------------ #
# the front door
# ------------------------------------------------------------------ #
def compile(graph: Graph, program, plan: ExecutionPlan | None = None, *,
            mapping=None, device=None,
            order: np.ndarray | None = None, store=None) -> CompiledQuery:
    """Compile a (graph, program, plan) triple into a query session.

    graph   -- a `repro_torch.graphs.Graph`.
    program -- a registered algorithm name ('bfs', 'sssp', ...), a
               `VertexAlgebra`, or a `Program`.
    plan    -- an `ExecutionPlan` (default `ExecutionPlan()`), validated
               and resolved here for the device. With ``plan.tuned`` set
               (e.g. `ExecutionPlan.auto(tuned=True)`), the plan
               autotuner picks the performance knobs for this (graph,
               program, device) -- consulting the tuning store first, so
               repeat compiles of the same shape are instant -- and the
               session's `tune` holds the `TuneReport`. Tuning is policy
               only: the answers are the default plan's.
    mapping -- optional FLIP `Mapping` (`repro_torch.core.
               compile_mapping`): the placement-induced vertex ordering
               becomes block sparsity, exactly as in `FlipEngine.build`.
    device  -- where the blocks and the state live: the CUDA device by
               default; pass "cpu" to run the plain version on the CPU.
    order   -- optional precomputed vertex order (order[k] = original id
               at tiled position k); a `mapping` takes its place, and
               passing both raises.
    store   -- optional `repro_torch.autotune.TuningStore` for tuned
               plans (default: the `FLIP_TORCH_AUTOTUNE_DB` / user-cache
               store). The tuner prices candidates in id order; a
               `mapping` or `order` applies to the session it returns.
    """
    prog = Program.of(program)
    plan = plan if plan is not None else ExecutionPlan()
    dev = resolve_device(device, "flip_torch.compile")
    tune = None
    if plan.tuned:
        plan.validate(prog.algebra)
        from repro_torch.autotune import resolve_tuned
        rplan, tune = resolve_tuned(graph, prog, plan, store=store,
                                    device=dev)
    else:
        rplan = plan.resolve(prog.algebra, dev)
    engine = FlipEngine.build(graph, prog.algebra, mapping=mapping,
                              order=order,
                              tile=rplan.tile, mode=rplan.mode,
                              relax_mode=rplan.relax_mode,
                              compact=rplan.compact,
                              feature_dim=rplan.feature_dim, device=dev)
    engine = dataclasses.replace(engine, max_steps=rplan.max_steps)
    return CompiledQuery(graph=graph, program=prog, plan=rplan,
                         engine=engine, tune=tune)
