"""The port's frontier engine: one host-driven fixpoint over the relax step.

The port of `repro.core.engine.FlipEngine`, in its two fabric modes:

  * data-centric -- frontier-driven: each step relaxes only blocks with
    active sources (the CUDA kernel skips inactive blocks for each
    query), and the new frontier is the set of vertices the algebra
    marks active (attribute ⊕-improved for monotone algebras, residual
    above tolerance for delta-PageRank). FLIP's packet-triggered
    execution.
  * op-centric   -- the classic-CGRA analogue: a full relaxation sweep
    every step, no data-driven skipping.

Execution is batched over independent queries: the state is
(B, ntiles, T[, d]) on the engine's device. Every mode runs the same
host loop, the semantics of the reference's `_fixpoint_host`: one
`frontier.any()` read per step, a per-query live mask that freezes
queries whose frontier emptied or whose step budget or deadline ran out
(a frozen query keeps its frontier, so it reads non-converged), and
flagged partial results. Each step is exactly one relax launch, so on
the card the kernel's launch count equals the fixpoint's iterations.

Not ported yet (ROADMAP Queue 1): warm starts and updates, tracing, the
segment surface, the distributed fixpoint, and a captured (CUDA-graph)
loop. The reference proves its on-device while_loop bit-equal to this
host loop, so the port keeps only the host loop.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.algebra import VertexAlgebra
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.frontier.ops import (BlockedGraph, build_blocks,
                                              frontier_relax)
from repro_torch.resilience.errors import InvalidRequest


@dataclasses.dataclass
class ExecutionDetail:
    """One `execute(detail=True)` outcome: attrs in original vertex
    order, per-query steps, the per-query convergence mask (False = the
    query was frozen by a step budget, a deadline or `max_steps`: its
    attrs are a flagged partial) and which of those stops were the
    deadline's. Scalar source -> scalar fields, batch -> (B,) arrays."""
    attrs: np.ndarray
    steps: int | np.ndarray
    converged: bool | np.ndarray
    deadline_expired: bool | np.ndarray


@dataclasses.dataclass
class FlipEngine:
    """Compiled graph + algorithm on one device."""

    bg: BlockedGraph
    algo: str
    mode: str = "data"          # 'data' (FLIP) or 'op' (classic CGRA)
    relax_mode: str = "auto"    # kernel dispatch: auto/cuda/torch
    compact: bool | str = "auto"  # plain version only: 'auto' = on for
                                  # data mode (the kernel always skips)
    max_steps: int = 100_000
    feature_dim: int = 1        # feature width d of the vertex state

    # -------------------------------------------------------------- #
    @staticmethod
    def build(graph: Graph, algo: str | VertexAlgebra,
              order: np.ndarray | None = None, tile: int = 128,
              mode: str = "data", relax_mode: str = "auto",
              compact: bool | str = "auto",
              feature_dim: int | None = None,
              device: str | torch.device = "cpu") -> "FlipEngine":
        """Block `graph` for `algo` on `device`. `order` is an optional
        precomputed vertex order (order[k] = original id at tiled
        position k), e.g. from the reference's FLIP mapping compiler."""
        bg = build_blocks(graph, algo=algo, tile=tile, order=order,
                          device=device)
        d = bg.algebra.feature_dim if feature_dim is None else feature_dim
        if bg.algebra.feature_dim > 1 and d != bg.algebra.feature_dim:
            raise ValueError(
                f"{bg.algebra.name} natively carries feature_dim "
                f"{bg.algebra.feature_dim}; cannot run it at "
                f"feature_dim {d}")
        return FlipEngine(bg=bg, algo=bg.algebra.name, mode=mode,
                          relax_mode=relax_mode, compact=compact,
                          feature_dim=d)

    @property
    def algebra(self) -> VertexAlgebra:
        return self.bg.algebra

    @property
    def device(self) -> torch.device:
        return self.bg.device

    @property
    def _features(self) -> bool:
        return self.feature_dim > 1

    @property
    def _use_compact(self) -> bool:
        if self.compact == "auto":
            return self.mode == "data"
        return bool(self.compact)

    # -------------------------------------------------------------- #
    def initial_state(self, srcs):
        """(attrs, aux, frontier) tensors for a batch of sources:
        (B, ntiles, T[, d]) f32 state and a (B, ntiles, T) bool
        frontier; padded lanes hold the ⊕-identity so they never
        activate or contribute."""
        bg, alg = self.bg, self.algebra
        d, features = self.feature_dim, self._features
        srcs = np.atleast_1d(np.asarray(srcs, dtype=np.int64))
        b = srcs.shape[0]
        attrs = bg.to_tiled(alg.initial_attrs(bg.n, srcs, feature_dim=d),
                            features=features)
        frontier = np.zeros((b, bg.padded_n), dtype=bool)
        frontier[:, bg.perm] = alg.initial_frontier(bg.n, srcs,
                                                    feature_dim=d)
        aux = torch.zeros_like(attrs)
        frontier = torch.from_numpy(
            frontier.reshape(b, bg.ntiles, bg.tile)).to(self.device)
        return attrs, aux, frontier

    def _step(self, attrs, aux, frontier):
        alg, features = self.algebra, self._features
        sv, carry = alg.scatter_carry(attrs, frontier,
                                      op_mode=(self.mode == "op"),
                                      features=features)
        new = frontier_relax(sv, carry, self.bg, mode=self.relax_mode,
                             compact=self._use_compact,
                             feature_dim=self.feature_dim)
        return alg.post_step(attrs, aux, sv, new, features=features)

    def _masked_step(self, attrs, aux, frontier, live: np.ndarray):
        """One relax step with the per-query freeze applied: queries not
        in `live` ((B,) bool) keep their state *and their frontier*, so
        a budget-frozen query still reads as non-converged while a
        finished one stays finished."""
        attrs_n, aux_n, frontier_n = self._step(attrs, aux, frontier)
        if live.all():                    # torch.where would be identity
            return attrs_n, aux_n, frontier_n
        lv = torch.from_numpy(live).to(self.device)
        ms = lv.reshape(lv.shape + (1,) * (attrs.ndim - 1))
        return (torch.where(ms, attrs_n, attrs),
                torch.where(ms, aux_n, aux),
                torch.where(lv[:, None, None], frontier_n, frontier))

    def _fixpoint(self, attrs, aux, frontier, budgets=None,
                  deadlines_t=None):
        """Host-driven fixpoint with per-query live masking, step
        budgets ((B,) ints, default `max_steps`) and absolute
        `time.monotonic` deadlines ((B,), +inf = none), enforced at step
        boundaries. Returns ``(attrs, aux, steps, converged, expired)``
        with (B,) numpy steps and masks."""
        b = int(attrs.shape[0])
        if budgets is None:
            budgets = np.full(b, self.max_steps, dtype=np.int32)
        budgets = np.asarray(budgets)
        deadlines = (None if deadlines_t is None
                     or not np.isfinite(deadlines_t).any()
                     else np.broadcast_to(np.asarray(deadlines_t,
                                                     dtype=np.float64),
                                          (b,)))
        expired = np.zeros(b, dtype=bool)
        steps = np.zeros(b, np.int32)
        while True:
            # the loop's one device->host read per step
            active = frontier.flatten(1).any(dim=1).cpu().numpy()
            if deadlines is not None:
                # a deadline only expires a query that has work left
                expired |= active & (deadlines <= time.monotonic())
            live = active & ~expired & (steps < budgets)
            if not live.any():
                break
            attrs, aux, frontier = self._masked_step(attrs, aux, frontier,
                                                     live)
            steps = steps + live.astype(np.int32)
        return attrs, aux, steps, ~active, expired

    # -------------------------------------------------------------- #
    def execute(self, srcs, *, max_steps=None, deadline_s=None,
                detail: bool = False):
        """Run the fixpoint from `srcs`: a scalar source is a solo query
        (`(n,)` result, int steps), a sequence a batch (`(B, n)` /
        `(B,)`). `max_steps` (int or (B,) ints) caps each query's steps
        below `self.max_steps`; `deadline_s` (relative seconds, scalar
        or (B,)) stops a query at the first step boundary past its
        deadline. Returns ``(out, steps)``, or an `ExecutionDetail` with
        `detail=True`."""
        batched = bool(np.ndim(srcs))
        srcs = np.atleast_1d(np.asarray(srcs, dtype=np.int64))
        budgets = self._resolve_budgets(max_steps, len(srcs))
        deadlines_t = self._resolve_deadlines(deadline_s, len(srcs))
        attrs0, aux0, frontier0 = self.initial_state(srcs)
        attrs, aux, steps, conv, expired = self._fixpoint(
            attrs0, aux0, frontier0, budgets=budgets,
            deadlines_t=deadlines_t)
        out = self.bg.to_orig(self.algebra.finalize(attrs, aux),
                              features=self._features)
        if detail:
            if batched:
                return ExecutionDetail(attrs=out, steps=steps,
                                       converged=conv,
                                       deadline_expired=expired)
            return ExecutionDetail(attrs=out[0], steps=int(steps[0]),
                                   converged=bool(conv[0]),
                                   deadline_expired=bool(expired[0]))
        return (out, steps) if batched else (out[0], int(steps[0]))

    def _resolve_budgets(self, max_steps, b: int):
        """Per-query step budgets ((B,) i32) from a caller cap: None
        keeps the session valve; an int or (B,) sequence is validated
        (>= 1) and clipped to `self.max_steps`."""
        if max_steps is None:
            return None
        budgets = np.atleast_1d(np.asarray(max_steps))
        if not np.issubdtype(budgets.dtype, np.integer):
            raise InvalidRequest(
                f"max_steps must be an int or a sequence of ints, got "
                f"dtype {budgets.dtype}", value=max_steps)
        if budgets.shape not in ((1,), (b,)):
            raise InvalidRequest(
                f"max_steps shape {budgets.shape} does not match the "
                f"{b} queries (scalar or one budget per query)",
                value=max_steps)
        if (budgets < 1).any():
            bad = int(budgets[budgets < 1][0])
            raise InvalidRequest(
                f"max_steps must be >= 1, got {bad}", value=bad)
        return np.minimum(
            np.broadcast_to(budgets, (b,)), self.max_steps
        ).astype(np.int32)

    def _resolve_deadlines(self, deadline_s, b: int):
        """Absolute per-query `time.monotonic` deadlines ((B,) f64) from
        relative seconds (scalar or per query; None / non-finite entries
        mean no deadline). rel <= 0 is legal: a bucketed query's later
        chunks may arrive with their deadline already spent and come
        back at once as flagged partials."""
        if deadline_s is None:
            return None
        now = time.monotonic()
        rel = np.atleast_1d(np.asarray(
            [np.inf if d is None else float(d)
             for d in np.atleast_1d(deadline_s)], dtype=np.float64))
        if rel.shape not in ((1,), (b,)):
            raise InvalidRequest(
                f"deadline_s shape {rel.shape} does not match the "
                f"{b} queries (scalar or one deadline per query)",
                value=deadline_s)
        if not np.isfinite(rel).any():
            return None
        return np.broadcast_to(now + rel, (b,)).copy()
