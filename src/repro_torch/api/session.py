"""The compile-then-query session: `flip_torch.compile(graph, program, plan)`.

The port of `repro.api.session`:

    import flip_torch

    cq = flip_torch.compile(graph, "sssp")        # on the CUDA device
    r = cq.query(5)                               # scalar -> (n,) attrs
    rb = cq.query([0, 5, 9])                      # batch  -> (B, n)
    assert r.check()                              # vs the numpy oracle

`query` handles scalar, batched and bucketed (plan.batch > 0) execution;
the plan decides *how*, never *what*. A session runs on the CUDA device
unless the caller passes ``device="cpu"``; with no CUDA device and no
explicit device, `compile` raises instead of quietly running on the CPU.
Warm starts (`query(warm=)`, `update`) and tracing (`query(trace=)`) are
not ported yet (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.program import Program
from repro_torch.core.engine import FlipEngine
from repro_torch.graphs.csr import Graph
from repro_torch.resilience.errors import ConvergenceFailure, InvalidRequest


@dataclasses.dataclass
class QueryResult:
    """One query's outcome: attrs in original vertex order ((n,) for a
    scalar source, (B, n) for a batch), per-query relaxation step counts
    (int / (B,) to match), the sources as queried, the resolved plan,
    and wall seconds.

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
        max_steps  -- per-request step budget (int, or one per source),
                      clipped to plan.max_steps; a query it stops comes
                      back with ``converged`` False.
        deadline_s -- per-request wall-clock budget in seconds from this
                      call (default plan.deadline_s), enforced at step
                      boundaries; `deadline_expired` marks queries it
                      stopped.
        warm, trace -- not ported yet (ROADMAP Queue 1 item 3); passing
                      either raises.
        """
        if warm is not None:
            raise NotImplementedError(
                "query(warm=...) is not ported yet (ROADMAP Queue 1 item 3, "
                "warm starts and updates); recompute from scratch")
        if trace:
            raise NotImplementedError(
                "query(trace=...) is not ported yet (ROADMAP Queue 1 item "
                "3, tracing)")
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
                deadline_expired=np.zeros(0, dtype=bool))
        if not batched or self.plan.batch == 0:
            det = self._dispatch(srcs, budgets, deadline_abs)
            out, steps = det.attrs, det.steps
            conv, expired = det.converged, det.deadline_expired
            dispatches = 1
        else:
            out, steps, conv, expired, dispatches = self._query_bucketed(
                np.atleast_1d(np.asarray(srcs, dtype=np.int64)), budgets,
                deadline_abs)
        return QueryResult(attrs=out, steps=steps,
                           srcs=(np.asarray(srcs) if batched
                                 else int(srcs)),
                           plan=self.plan, program=self.program,
                           graph=self.graph,
                           wall_s=time.perf_counter() - t0,
                           dispatches=dispatches, converged=conv,
                           deadline_expired=expired)

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

    def _dispatch(self, srcs, budgets=None, deadline_abs=None):
        remaining = (None if deadline_abs is None
                     else np.asarray(deadline_abs) - time.monotonic())
        return self.engine.execute(srcs, max_steps=budgets,
                                   deadline_s=remaining, detail=True)

    def _query_bucketed(self, srcs, budgets=None, deadline_abs=None):
        """plan.batch-sized dispatch: pad the tail bucket by repeating
        its last source (budgets and deadlines pad along with it) so
        every dispatch has one (B, ntiles, T) shape, then drop the
        padded rows."""
        nb = self.plan.batch
        outs, steps, convs, exps = [], [], [], []

        def pad(arr, i, k):
            if arr is None:
                return None
            chunk = np.asarray(arr)[i:i + k]
            return np.concatenate([chunk, np.repeat(chunk[-1:], nb - k)])

        for i in range(0, len(srcs), nb):
            k = len(srcs[i:i + nb])
            det = self._dispatch(pad(srcs, i, k), pad(budgets, i, k),
                                 pad(deadline_abs, i, k))
            outs.append(det.attrs[:k])
            steps.append(det.steps[:k])
            convs.append(np.atleast_1d(det.converged)[:k])
            exps.append(np.atleast_1d(det.deadline_expired)[:k])
        return (np.concatenate(outs), np.concatenate(steps),
                np.concatenate(convs), np.concatenate(exps), len(outs))


def resolve_device(device=None) -> torch.device:
    """The session's device: `device` if given, else the CUDA device.
    With no CUDA device and no explicit choice this raises -- the port
    never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flip_torch.compile: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


# ------------------------------------------------------------------ #
# the front door
# ------------------------------------------------------------------ #
def compile(graph: Graph, program, plan: ExecutionPlan | None = None, *,
            device=None, order: np.ndarray | None = None) -> CompiledQuery:
    """Compile a (graph, program, plan) triple into a query session.

    graph   -- a `repro_torch.graphs.Graph`.
    program -- a registered algorithm name ('bfs', 'sssp', ...), a
               `VertexAlgebra`, or a `Program`.
    plan    -- an `ExecutionPlan` (default `ExecutionPlan()`), validated
               and resolved here for the device.
    device  -- where the blocks and the state live: the CUDA device by
               default; pass "cpu" to run the plain version on the CPU.
    order   -- optional precomputed vertex order (order[k] = original id
               at tiled position k), e.g. from a FLIP mapping.
    """
    prog = Program.of(program)
    plan = plan if plan is not None else ExecutionPlan()
    dev = resolve_device(device)
    rplan = plan.resolve(prog.algebra, dev)
    engine = FlipEngine.build(graph, prog.algebra, order=order,
                              tile=rplan.tile, mode=rplan.mode,
                              relax_mode=rplan.relax_mode,
                              compact=rplan.compact,
                              feature_dim=rplan.feature_dim, device=dev)
    engine = dataclasses.replace(engine, max_steps=rplan.max_steps)
    return CompiledQuery(graph=graph, program=prog, plan=rplan,
                         engine=engine)
