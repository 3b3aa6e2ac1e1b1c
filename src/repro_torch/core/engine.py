"""The port's frontier engine: the fixpoint over the relax step, on the
device or driven from the host.

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
(B, ntiles, T[, d]) on the engine's device. Two drivers run the same
step (`_masked_step`) with the same per-query live mask, which freezes
queries whose frontier emptied or whose step budget ran out (a frozen
query keeps its frontier, so it reads non-converged), so their results
are bit for bit the same:

  * the device loop (`_fixpoint_device`, the reference's
    `_dense_fixpoint_jit`): the live mask stays on the device, and the
    steps run in chunks of up to `DEVICE_CHUNK` with one device->host
    read per chunk. On the card each chunk is captured once as a CUDA
    graph and replayed; on the CPU the same chunk runs eagerly. The steps
    past the fixpoint at the end of the last chunk are exact no-ops
    (every lane frozen), so K1 runs Σ L times for a fixpoint of
    `iterations` steps: iterations <= launches < iterations +
    DEVICE_CHUNK (one chunk of no-ops when no query is live at entry).
    A replay credits K1's launch count with the launches its capture
    recorded.
  * the host loop (`_fixpoint_host`, the reference's `_fixpoint_host`):
    one `frontier.any()` read per step, one launch per step, and the
    step boundaries the host needs for deadlines, per-step wall times
    and a rank step whose collective runs on the host (gloo). The CPU's
    plain version runs here too, as the reference's jnp route does.

`fixpoint_route` is the rule between them. On top of the two, as in
the reference:
  * the distributed fixpoint (`execute(distributed=True, mesh=)`): the
    destination tiles split over the ranks of a `torch.distributed`
    process group, queries replicated. Each rank relaxes its own slab of
    blocks (K1 on the card) and one all-gather per step re-forms the
    replicated state -- FLIP's NoC scatter. Its rank step (`RankStep`)
    runs on the device loop, all-gather included, where a CUDA graph can
    record the collective (NCCL, or one rank with no group): the
    reference's on-device `dist_fix`. Over gloo, whose collectives run on
    the host, it keeps the host loop;
  * warm starts (`WarmStart`, `resolve_warm`, `apply_updates`):
    incremental recompute after a monotone edge batch, seeded at the
    sources whose out-edges changed;
  * tracing (`execute(trace=)`): per-step frontier stats into
    `repro_torch.obs`, kept on the device until the loop ends, so
    tracing adds no device->host read per step;
  * program spans (`repro_torch.obs.span`) in the host code of the loops:
    `flip.init`, `flip.fixpoint` over either loop, `flip.capture` over a
    CUDA graph's capture, `flip.finalize`; per chunk (`fine_span`,
    recorded only after `obs.enable(True)`) one `flip.chunk` per replay
    (a host-loop step) and `flip.read` over the loop's device->host read;
    and the `PROGRAM` counters (chunks, steps enqueued, iterations).
    None sits in code that a CUDA graph captures;
  * the segment surface (`idle_state`, `write_slot`, `run_segment`,
    `finalize_state`) that the continuous-batching scheduler
    (`repro_torch.serving`) drives;
  * the deprecated `run`, `run_batch`, `run_distributed` and
    `run_updated`, shims over `execute`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.algebra import VertexAlgebra
from repro_torch.core.mapping import Mapping
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.frontier.frontier import frontier_relax_cuda
from repro_torch.kernels.frontier.ops import (BlockedGraph, UpdateDelta,
                                              build_blocks, frontier_relax,
                                              resolve_relax_mode,
                                              tile_activity)
from repro_torch.obs.metrics import PROGRAM
from repro_torch.obs.telemetry import DispatchTelemetry, StepTrace
from repro_torch.obs.trace import fine_span, span
from repro_torch.resilience.errors import InvalidRequest

# default per-step trace row capacity (`execute(trace=True)`); steps
# beyond it still execute exactly, only their rows are dropped (flagged
# `truncated`)
TRACE_CAP_DEFAULT = 4096

# steps per chunk of the device loop: one device->host read per chunk,
# and at most DEVICE_CHUNK - 1 no-op steps past a fixpoint's end
DEVICE_CHUNK = 8

# the fixpoint's always-on counters (see `repro_torch.obs.metrics`)
_CHUNKS = PROGRAM.counter("fixpoint.chunks")
_STEPS_ENQUEUED = PROGRAM.counter("fixpoint.steps_enqueued")
_ITERATIONS = PROGRAM.counter("fixpoint.iterations")


def fixpoint_route(device_type: str, relax_mode: str, deadlined: bool,
                   rank_step: bool, capturable: bool = False) -> str:
    """The driver of one fixpoint: "device" (`_fixpoint_device`, captured
    on the card) or "host" (`_fixpoint_host`). The reference's rule
    (`repro.core.engine` `FlipEngine._fixpoint`) on the port's routes: a
    finite deadline needs host-observable step boundaries; the CPU's
    plain version is the counterpart of the reference's jnp route and its
    host driver; a CUDA engine on the kernel runs the device loop, with
    the distributed fixpoint's rank step in it (the reference's
    `dist_fix`) when a CUDA graph can record the step's collective
    (`capturable`, `RankStep.capturable`: NCCL, or no group), and on the
    host loop otherwise (gloo). `relax_mode` is resolved ("cuda" or
    "torch")."""
    if deadlined or (rank_step and not capturable):
        return "host"
    if device_type == "cuda" and relax_mode == "cuda":
        return "device"
    return "host"


@dataclasses.dataclass
class _CapturedLoop:
    """The device loop's CUDA graphs for one (B, trace_cap, step) on one
    engine: the static state that every chunk reads and writes back
    (attrs, aux, frontier, steps, iterations, then the trace buffers),
    the budgets, the chunk's summary (see `FlipEngine._loop_summary`),
    the rank step the chunks run (None: the local step), and one graph
    per chunk length L with the K1 launches its capture recorded."""
    state: tuple
    budgets: torch.Tensor
    summary: torch.Tensor
    trace_cap: int
    step: RankStep | None = None
    graphs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, eq=False)
class RankStep:
    """One rank's step of the distributed fixpoint, on the rank's slab of
    an engine's layout (`FlipEngine._rank_slab`), over `group` (None: one
    rank, no collective). `_fixpoint` takes it as its `step` and calls it
    with the engine. It holds no engine: the engine's captured loops keep
    their step, so a step holding the engine would make a reference loop
    that only the cycle collector could free (the slab on the card, the
    graphs' pools). `key` keys the rank's captured loops apart from the
    engine's local ones and from another rank's, world's or group's; it
    holds the group object itself, whose id a destroyed group could hand
    on."""
    slab: BlockedGraph
    rank: int
    world: int
    group: object = None

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can record the step's collective: NCCL's
        can (the warm-up chunk makes the communicator before the
        capture); gloo runs its collectives on the host. With no group
        there is no collective."""
        return self.group is None or dist.get_backend(self.group) == "nccl"

    @property
    def key(self) -> tuple:
        return (self.rank, self.world, self.group)

    def pad(self, engine, state):
        """A replicated (attrs, aux, frontier) state of `engine` padded
        from `ntiles` to ``ntiles_p = world x tpd`` tiles: ⊕-identity
        attrs, zero aux, an empty frontier, so padding never activates or
        contributes."""
        attrs, aux, frontier = state
        pad = self.slab.ntiles * self.world - engine.bg.ntiles
        if not pad:
            return attrs, aux, frontier
        widths = (0, 0) * (attrs.ndim - 2) + (0, pad)
        zero = float(engine.algebra.semiring.zero)
        return (torch.nn.functional.pad(attrs, widths, value=zero),
                torch.nn.functional.pad(aux, widths),
                torch.nn.functional.pad(frontier, (0, 0, 0, pad)))

    def __call__(self, engine, attrs, aux, frontier):
        """One distributed step of `engine` on this rank: relax the slab's
        tiles ``[t0, t0 + tpd)`` (t0 = rank x tpd) from the replicated
        state, then all-gather the new slabs into the replicated (B,
        ntiles_p, T[, d]) state.

        A rank with no block, and, on the CPU in data mode, a rank none
        of whose blocks has an active source tile (the reference's idle
        skip for a whole device, its `lax.cond` at
        `repro/core/engine.py:888`), returns its carry without a relax;
        it still joins the collective. That idle test reads the device,
        so on the card, where the step runs inside the device loop's
        chunks, the port departs from the reference: the rank relaxes its
        slab, and K1 skips each inactive source tile itself. The result
        is the same on finite weights; a NaN weight is the one operand
        where a relaxed identity tile differs (ROADMAP Queue 3, "one
        behaviour to know")."""
        slab = self.slab
        alg, features = engine.algebra, engine._features
        sv, carry = alg.scatter_carry(attrs, frontier,
                                      op_mode=(engine.mode == "op"),
                                      features=features)
        t0 = self.rank * slab.ntiles
        carry_l = carry[:, t0:t0 + slab.ntiles].contiguous()
        nb = int(slab.bsrc.shape[0])
        idle = nb == 0 or (
            engine._use_compact and not sv.is_cuda
            and not bool(tile_activity(sv, slab.semiring, features)
                         [slab.bsrc.long()].any()))
        new_l = carry_l if idle else frontier_relax(
            sv, carry_l, slab, mode=engine.relax_mode,
            compact=engine._use_compact, feature_dim=engine.feature_dim)
        if self.group is not None:
            # all_gather_into_tensor concatenates along dim 0: gather
            # rank-major (world, B, tpd, ...) and move the rank axis next
            # to the tile axis once per step -- one copy of the state,
            # where a tile-major state would change every algebra hook
            b = new_l.shape[0]
            buf = new_l.new_empty((self.world * b,) + tuple(new_l.shape[1:]))
            dist.all_gather_into_tensor(buf, new_l, group=self.group)
            new_l = buf.view((self.world, b) + tuple(new_l.shape[1:])) \
                .transpose(0, 1).reshape(
                    (b, self.world * slab.ntiles) + tuple(new_l.shape[2:]))
        return alg.post_step(attrs, aux, sv, new_l, features=features)


@dataclasses.dataclass
class WarmStart:
    """Resume state for delta-driven incremental recompute.

    `attrs` is the converged result of a prior run on the pre-update
    engine, in original vertex order: `(n,)` (applied to every query of
    the batch) or `(B, n)` matching the batch (a trailing d at
    feature_dim d > 1). `seeds` holds the original ids of the vertices
    whose out-edge ⊗ operands changed (`UpdateDelta.affected_src`): they
    form the initial frontier, so the fixpoint relaxes only what the
    batch can improve. Sound only for monotone algebras under a
    `Semiring.monotone_under` batch -- `resolve_warm` decides."""
    attrs: np.ndarray
    seeds: np.ndarray


@dataclasses.dataclass
class ExecutionDetail:
    """One `execute(detail=True)` outcome: attrs in original vertex
    order, per-query steps, the per-query convergence mask (False = the
    query was frozen by a step budget, a deadline or `max_steps`: its
    attrs are a flagged partial), which of those stops were the
    deadline's, and the dispatch's telemetry when it ran traced. Scalar
    source -> scalar fields, batch -> (B,) arrays."""
    attrs: np.ndarray
    steps: int | np.ndarray
    converged: bool | np.ndarray
    deadline_expired: bool | np.ndarray
    telemetry: DispatchTelemetry | None = None


def mapping_order(mapping: Mapping) -> np.ndarray:
    """Vertex ordering induced by the FLIP placement: vertices co-located
    on a (copy, PE) become adjacent tile positions, so the compiled
    placement's locality becomes block sparsity."""
    keys = [(int(mapping.copy_of[v]), int(mapping.pe_of[v]), v)
            for v in range(mapping.graph.n)]
    return np.asarray([v for _, _, v in sorted(keys)], dtype=np.int64)


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
    # where the fixpoint state lives when the layout stays on the host
    # (a distributed plan: each rank copies only its slab to the device);
    # None = the layout's device
    state_device: torch.device | None = None
    # (rank, world) -> the rank's slab of `bg` on the state's device
    _slabs: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    # -------------------------------------------------------------- #
    @staticmethod
    def build(graph: Graph, algo: str | VertexAlgebra,
              mapping: Mapping | None = None,
              order: np.ndarray | None = None, tile: int = 128,
              mode: str = "data", relax_mode: str = "auto",
              compact: bool | str = "auto",
              feature_dim: int | None = None,
              device: str | torch.device | None = None,
              host_layout: bool = False) -> "FlipEngine":
        """Block `graph` for `algo` on `device` (default: the CUDA
        device; raises without one). The tiled vertex order comes from a
        FLIP `mapping` (`mapping_order`: the placement's locality becomes
        block sparsity) or from a precomputed `order` (order[k] =
        original id at tiled position k); passing both raises. Neither
        means id order. `host_layout` keeps the blocks in host memory and
        only the state on `device`: such an engine runs the distributed
        fixpoint only, each rank copying its own slab to the device."""
        if mapping is not None:
            if order is not None:
                raise ValueError(
                    "FlipEngine.build: pass a mapping or an order, not "
                    "both (the mapping induces its own order)")
            order = mapping_order(mapping)
        device = resolve_device(device, "FlipEngine.build")
        bg = build_blocks(graph, algo=algo, tile=tile, order=order,
                          device="cpu" if host_layout else device)
        d = bg.algebra.feature_dim if feature_dim is None else feature_dim
        if bg.algebra.feature_dim > 1 and d != bg.algebra.feature_dim:
            raise ValueError(
                f"{bg.algebra.name} natively carries feature_dim "
                f"{bg.algebra.feature_dim}; cannot run it at "
                f"feature_dim {d}")
        return FlipEngine(bg=bg, algo=bg.algebra.name, mode=mode,
                          relax_mode=relax_mode, compact=compact,
                          feature_dim=d,
                          state_device=device if host_layout else None)

    @property
    def algebra(self) -> VertexAlgebra:
        return self.bg.algebra

    @property
    def device(self) -> torch.device:
        """Where the fixpoint state lives."""
        return self.state_device or self.bg.device

    @property
    def _features(self) -> bool:
        return self.feature_dim > 1

    @property
    def _use_compact(self) -> bool:
        if self.compact == "auto":
            return self.mode == "data"
        return bool(self.compact)

    # -------------------------------------------------------------- #
    def initial_state(self, srcs, warm: WarmStart | None = None):
        """(attrs, aux, frontier) tensors for a batch of sources:
        (B, ntiles, T[, d]) f32 state and a (B, ntiles, T) bool
        frontier; padded lanes hold the ⊕-identity so they never
        activate or contribute. Built on the host, moved once.

        With `warm`, the fixpoint resumes from a prior converged result:
        attrs come from `warm.attrs` and only `warm.seeds` start
        active."""
        bg, alg = self.bg, self.algebra
        d, features = self.feature_dim, self._features
        srcs = np.atleast_1d(np.asarray(srcs, dtype=np.int64))
        b = srcs.shape[0]
        with span("flip.init", batch=b):
            frontier = np.zeros((b, bg.padded_n), dtype=bool)
            if warm is not None:
                if alg.kind != "monotone":
                    raise ValueError(
                        f"warm start needs a monotone algebra; {alg.name} "
                        f"is {alg.kind!r} -- recompute from scratch instead")
                prev = np.asarray(warm.attrs, dtype=np.float32)
                want = (b, bg.n, d) if features else (b, bg.n)
                if features and (prev.ndim < 2 or prev.shape[-1] != d):
                    wd = prev.shape[-1] if prev.ndim >= 2 else 1
                    raise ValueError(
                        f"warm attrs carry feature_dim {wd} but this "
                        f"engine runs {alg.name} at feature_dim {d}; "
                        f"warm state shape {prev.shape} != {want}")
                if prev.ndim == len(want) - 1:   # shared across the batch
                    prev = np.broadcast_to(prev, want)
                if prev.shape != want:
                    raise ValueError(
                        f"warm attrs shape {prev.shape} does not match "
                        f"{want} (B={b}, n={bg.n}"
                        + (f", d={d})" if features else ")"))
                attrs = bg.to_tiled(prev, features=features)
                seeds = np.asarray(warm.seeds, dtype=np.int64)
                frontier[:, bg.perm[seeds]] = True
            else:
                attrs = bg.to_tiled(
                    alg.initial_attrs(bg.n, srcs, feature_dim=d),
                    features=features)
                frontier[:, bg.perm] = alg.initial_frontier(bg.n, srcs,
                                                            feature_dim=d)
            attrs = attrs.to(self.device)
            aux = torch.zeros_like(attrs)
            frontier = torch.from_numpy(
                frontier.reshape(b, bg.ntiles, bg.tile)).to(self.device)
            return attrs, aux, frontier

    def _step(self, attrs, aux, frontier, with_stats: bool = False):
        alg, features = self.algebra, self._features
        sv, carry = alg.scatter_carry(attrs, frontier,
                                      op_mode=(self.mode == "op"),
                                      features=features)
        new = frontier_relax(sv, carry, self.bg, mode=self.relax_mode,
                             compact=self._use_compact,
                             feature_dim=self.feature_dim)
        out = alg.post_step(attrs, aux, sv, new, features=features)
        if not with_stats:
            return out
        return out, self._step_stats(sv, frontier)

    def _step_stats(self, sv, frontier):
        """One trace row's stats as device tensors (no host read): the
        frontier entering the step, the per-tile activity of the
        scattered source values (the kernel's packet-trigger rule) and
        the blocks with an active source tile. Extra outputs only -- the
        step never reads them, so traced runs stay bit-identical.

        Returns ``(active_vertices (B,), active_tiles (), fetched ())``;
        `fetched` keeps the reference's definition: Σ tile_activity[bsrc]
        under compaction, every block under dense streaming (the kernel
        itself tests the trigger per (block, query))."""
        bg = self.bg
        act = tile_activity(sv, bg.semiring, self._features)   # (ntiles,)
        active_tiles = act.sum()
        if self._use_compact:
            fetched = act[bg.bsrc.long()].sum()
        else:
            fetched = torch.full_like(active_tiles, int(bg.bsrc.shape[0]))
        active_v = frontier.flatten(1).sum(dim=1)
        return active_v, active_tiles, fetched

    def _masked_step(self, attrs, aux, frontier, live,
                     with_stats: bool = False, step=None):
        """One relax step with the per-query freeze applied: queries not
        in `live` ((B,) bool) keep their state *and their frontier*, so
        a budget-frozen query still reads as non-converged while a
        finished one stays finished. `live` is a numpy mask (the host
        loop, which skips the `torch.where` when every query is live) or
        a bool tensor on the state's device (the device loop, which
        always applies it). `step` replaces the local `_step` (the
        distributed fixpoint's `RankStep`, called with this engine).
        Returns the step's own new tensors, or `torch.where` of them (a
        monotone algebra's aux, which no step reads, passes through)."""
        stepped = (step(self, attrs, aux, frontier) if step is not None
                   else self._step(attrs, aux, frontier,
                                   with_stats=with_stats))
        (attrs_n, aux_n, frontier_n), stats = \
            stepped if with_stats else (stepped, None)
        if isinstance(live, np.ndarray):
            if live.all():                # torch.where would be identity
                out = (attrs_n, aux_n, frontier_n)
                return (out, stats) if with_stats else out
            live = torch.from_numpy(live).to(self.device)
        ms = live.reshape(live.shape + (1,) * (attrs.ndim - 1))
        attrs_n = torch.where(ms, attrs_n, attrs)
        if aux_n is not aux:
            aux_n = torch.where(ms, aux_n, aux)
        frontier_n = torch.where(live[:, None, None], frontier_n, frontier)
        out = (attrs_n, aux_n, frontier_n)
        return (out, stats) if with_stats else out

    def _fixpoint(self, attrs, aux, frontier, trace_cap: int = 0,
                  budgets=None, deadlines_t=None, step=None):
        """The fixpoint with per-query live masking, step budgets ((B,)
        ints, default `max_steps`) and absolute `time.monotonic`
        deadlines ((B,), +inf = none). `step` is the distributed
        fixpoint's `RankStep` (untraced); None runs the local `_step`,
        which a host-layout engine refuses. `fixpoint_route` picks the
        driver: the device loop on a CUDA engine, the host loop for a
        finite deadline, a rank step over gloo or the CPU's plain
        version; both give the same results bit for bit.

        Returns ``(attrs, aux, frontier, steps, trace, converged,
        expired)``: (B,) numpy steps and masks; the final frontier, so a
        bounded-budget run resumes exactly (`run_segment`); and `trace`,
        a ``(StepTrace, truncated)`` pair when `trace_cap` > 0, else
        None."""
        if step is None and self.state_device is not None:
            raise ValueError(
                "this engine keeps its layout on the host for a "
                "distributed plan; it runs execute(distributed=True) only")
        b = int(attrs.shape[0])
        if budgets is None:
            budgets = np.full(b, self.max_steps, dtype=np.int32)
        budgets = np.asarray(budgets)
        deadlines = (None if deadlines_t is None
                     or not np.isfinite(deadlines_t).any()
                     else np.broadcast_to(np.asarray(deadlines_t,
                                                     dtype=np.float64),
                                          (b,)))
        route = fixpoint_route(
            self.device.type, resolve_relax_mode(self.relax_mode,
                                                 self.device),
            deadlines is not None, step is not None,
            step is not None and step.capturable)
        with span("flip.fixpoint", route=route, batch=b):
            if route == "device":
                out = self._fixpoint_device(attrs, aux, frontier,
                                            trace_cap, budgets, step)
            else:
                out = self._fixpoint_host(attrs, aux, frontier, trace_cap,
                                          budgets, deadlines, step)
        _ITERATIONS.inc(int(out[3].max(initial=0)))
        return out

    def _fixpoint_host(self, attrs, aux, frontier, trace_cap: int,
                       budgets: np.ndarray, deadlines, step=None):
        """The host loop (the reference's `_fixpoint_host`): one
        device->host read of `frontier.any()` per step, deadlines
        enforced at step boundaries, one launch per step. The trace rows
        stay on the device until the loop ends, and each step's wall
        closes at the next step's read (`StepTrace.step_wall_s`)."""
        b = int(attrs.shape[0])
        expired = np.zeros(b, dtype=bool)
        steps = np.zeros(b, np.int32)
        rows: list[tuple] = []
        walls: list[float] = []
        n_iter = 0
        t0 = time.perf_counter()
        while True:
            # the loop's one device->host read per step; it also closes
            # the previous traced step's wall
            with fine_span("flip.read"):
                active = frontier.flatten(1).any(dim=1).cpu().numpy()
            if len(walls) < len(rows):
                walls.append(time.perf_counter() - t0)
            if deadlines is not None:
                # a deadline only expires a query that has work left
                expired |= active & (deadlines <= time.monotonic())
            live = active & ~expired & (steps < budgets)
            if not live.any():
                break
            t0 = time.perf_counter()
            with fine_span("flip.chunk", n=1):
                if trace_cap:
                    (attrs, aux, frontier), st = self._masked_step(
                        attrs, aux, frontier, live, with_stats=True)
                    if n_iter < trace_cap:
                        rows.append(st + (~live,))
                else:
                    attrs, aux, frontier = self._masked_step(
                        attrs, aux, frontier, live, step=step)
            _CHUNKS.inc()
            _STEPS_ENQUEUED.inc()
            steps = steps + live.astype(np.int32)
            n_iter += 1
        trace = None
        if trace_cap:
            trace = (self._step_trace(rows, walls, b), n_iter > trace_cap)
        return attrs, aux, frontier, steps, trace, ~active, expired

    def _fixpoint_device(self, attrs, aux, frontier, trace_cap: int = 0,
                         budgets=None, step: RankStep | None = None):
        """The device loop, the reference's `_dense_fixpoint_jit` (and,
        with a rank `step`, its distributed `dist_fix`): the live mask
        (frontier non-empty and steps < budget) stays on the device, and
        the steps run in chunks of ``L = min(DEVICE_CHUNK, max(budgets) -
        steps run)``, each followed by one device->host read of the
        chunk's summary. A chunk's last steps past the fixpoint are exact
        no-ops (every lane frozen). On a CUDA tensor each chunk is a CUDA
        graph captured once per (B, L, trace_cap, step key) on this
        engine (`_replay`); on the CPU the same chunk runs eagerly. On
        the card a rank step makes no host read (`RankStep.__call__`)
        and its all-gather is recorded in the graph: every rank holds
        the same state and budgets, so every rank captures and replays
        the same chunk lengths in the same order. With `trace_cap` (the
        local step only), one stats row per iteration goes into fixed
        (trace_cap, ...) buffers on the device; rows past the capacity
        are dropped and the trace is flagged truncated. There are no
        per-step walls (`step_wall_s` is None), as on the reference's
        on-device loop.

        Returns `_fixpoint`'s 7-tuple; the state tensors are the
        caller's to keep (never a graph's static buffers)."""
        b = int(attrs.shape[0])
        budgets = np.broadcast_to(np.asarray(
            self.max_steps if budgets is None else budgets,
            dtype=np.int32), (b,))
        dev = attrs.device
        steps = torch.zeros(b, dtype=torch.int32, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        # the trace buffers' last row takes the rows past the capacity
        bufs = () if not trace_cap else (
            torch.zeros((trace_cap + 1, b), dtype=torch.int32, device=dev),
            torch.zeros(trace_cap + 1, dtype=torch.int32, device=dev),
            torch.zeros(trace_cap + 1, dtype=torch.int32, device=dev),
            torch.zeros((trace_cap + 1, b), dtype=torch.bool, device=dev))
        state = (attrs, aux, frontier, steps, iters) + bufs
        bud = torch.from_numpy(budgets.copy()).to(dev)
        loop = (self._captured_loop(state, bud, trace_cap, step)
                if dev.type == "cuda" else None)
        summary = None
        cap, run = int(budgets.max(initial=0)), 0
        while run < cap:
            n = min(DEVICE_CHUNK, cap - run)
            with fine_span("flip.chunk", n=n):
                if loop is not None:
                    out = self._replay(loop, n)
                else:
                    state, out = self._device_chunk(state, bud, n,
                                                    trace_cap, step=step)
            _CHUNKS.inc()
            _STEPS_ENQUEUED.inc(n)
            run += n
            with fine_span("flip.read"):
                summary = out.cpu().numpy()      # the one read per chunk
            if not summary[0]:
                break
        if loop is not None:
            state = tuple(x.clone() for x in loop.state)
        if summary is None:                      # every budget is 0
            summary = self._loop_summary(state[2], state[3], state[4],
                                         bud).cpu().numpy()
        n_iter = int(summary[1])
        steps_np = summary[2:2 + b].astype(np.int32)
        converged = summary[2 + b:].astype(bool)
        trace = None
        if trace_cap:
            rows = min(n_iter, trace_cap)
            av, at, bf, cv = (x[:rows].cpu().numpy() for x in state[5:])
            nb = int(self.bg.bsrc.shape[0])
            trace = (StepTrace(active_vertices=av, active_tiles=at,
                               blocks_fetched=bf,
                               blocks_skipped=np.int32(nb) - bf,
                               converged=cv),
                     n_iter > trace_cap)
        return (state[0], state[1], state[2], steps_np, trace, converged,
                np.zeros(b, dtype=bool))

    def _device_chunk(self, state, budgets, n: int, trace_cap: int,
                      step: RankStep | None = None):
        """`n` steps of the reference's while_loop body on the device
        state ``(attrs, aux, frontier, steps, iterations, *trace
        buffers)``: the live mask, the masked step (the local one, or the
        rank `step`, untraced) with `torch.where`, ``steps += live``
        and, with `trace_cap`, the iteration's stats
        row written at the iteration count (the spare last row once past
        the capacity or when no query is live) and the count advanced
        while any query is live (untraced, it stays 0). No host read: the
        chunk is captured as one CUDA graph. Returns ``(state,
        summary)``; the trace buffers are written in place."""
        attrs, aux, frontier, steps, iters = state[:5]
        bufs = state[5:]
        for _ in range(n):
            live = frontier.flatten(1).any(dim=1) & (steps < budgets)
            if trace_cap:
                (attrs, aux, frontier), stats = self._masked_step(
                    attrs, aux, frontier, live, with_stats=True)
                any_live = live.any()
                row = torch.where(any_live, iters.clamp(max=trace_cap),
                                  trace_cap).long().view(1)
                for buf, val in zip(bufs, stats + (~live,)):
                    buf.index_copy_(0, row, val.to(buf.dtype).reshape(
                        (1,) + buf.shape[1:]))
                iters = iters + any_live
            else:
                attrs, aux, frontier = self._masked_step(
                    attrs, aux, frontier, live, step=step)
            steps = steps + live
        return ((attrs, aux, frontier, steps, iters) + bufs,
                self._loop_summary(frontier, steps, iters, budgets))

    @staticmethod
    def _loop_summary(frontier, steps, iters, budgets) -> torch.Tensor:
        """One int32 vector the driver reads after a chunk: [any query
        still live, iterations (counted when tracing), steps (B),
        converged (B)]."""
        active = frontier.flatten(1).any(dim=1)
        more = (active & (steps < budgets)).any()
        return torch.cat([more.view(1).int(), iters.view(1).int(),
                          steps.int(), (~active).int()])

    def _captured_loop(self, state, budgets, trace_cap: int,
                       step: RankStep | None = None) -> _CapturedLoop:
        """This engine's `_CapturedLoop` for (B, trace_cap) and the local
        step or rank `step` (by `step.key`: a rank step's state is padded,
        it reads the rank's slab and records the group's all-gather, so
        it never shares a graph with a local query of the same B), made
        at first use, with `state` and `budgets` copied into its static
        tensors (once per fixpoint; the replays then chain on them). Kept
        in the instance's `__dict__`, never a dataclass field, so
        `dataclasses.replace` (`apply_updates`) gives the new engine no
        graph that points at this engine's blocks."""
        loops = self.__dict__.setdefault("_captured", {})
        b = int(state[0].shape[0])
        key = (b, trace_cap, None if step is None else step.key)
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = _CapturedLoop(
                state=tuple(torch.empty_like(x) for x in state),
                budgets=torch.empty_like(budgets),
                summary=torch.empty(2 + 2 * b, dtype=torch.int32,
                                    device=budgets.device),
                trace_cap=trace_cap, step=step)
        for dst, src in zip(loop.state, state):
            dst.copy_(src)
        loop.budgets.copy_(budgets)
        return loop

    def _replay(self, loop: _CapturedLoop, n: int) -> torch.Tensor:
        """Replay the chunk of `n` steps (captured at first use) on
        `loop`'s static state and credit K1's launch count with the
        launches its capture recorded. Returns the static summary."""
        entry = loop.graphs.get(n)
        if entry is None:
            entry = loop.graphs[n] = self._capture(loop, n)
        graph, launches = entry
        graph.replay()
        frontier_relax_cuda.launches += launches
        return loop.summary

    def _capture(self, loop: _CapturedLoop, n: int):
        """Capture one chunk of `n` steps over `loop`'s static state: the
        chunk, then copies of its new state and summary into the static
        tensors, so that replays chain. A warm-up chunk runs first on a
        side stream over copies of the state (the kernel's build and
        load, the allocator; a rank step's collectives, whose first call
        makes the NCCL communicator), as capture requires. Neither the
        warm-up's nor the capture's calls of K1 are fixpoint steps, so its
        count is put back. A failure raises: there is no fallback (on a
        rank step, the other ranks then wait in the collective until the
        group's timeout ends them)."""
        dev = loop.budgets.device
        before = frontier_relax_cuda.launches
        with span("flip.capture", n=n, batch=int(loop.budgets.shape[0])), \
                torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._device_chunk(tuple(x.clone() for x in loop.state),
                                   loop.budgets, n, loop.trace_cap,
                                   step=loop.step)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            start = frontier_relax_cuda.launches
            with torch.cuda.graph(graph):
                new, summary = self._device_chunk(loop.state, loop.budgets,
                                                  n, loop.trace_cap,
                                                  step=loop.step)
                for dst, src in zip(loop.state[:5], new[:5]):
                    if src is not dst:
                        dst.copy_(src)
                loop.summary.copy_(summary)
        launches = frontier_relax_cuda.launches - start
        frontier_relax_cuda.launches = before
        return graph, launches

    def _step_trace(self, rows, walls, b: int) -> StepTrace:
        """Stack the device-side trace rows once, after the loop."""
        nb = int(self.bg.bsrc.shape[0])
        if not rows:
            zero = np.zeros(0, np.int32)
            return StepTrace(active_vertices=np.zeros((0, b), np.int32),
                             active_tiles=zero, blocks_fetched=zero,
                             blocks_skipped=zero,
                             converged=np.zeros((0, b), bool),
                             step_wall_s=np.zeros(0, np.float64))

        def stacked(i):
            return torch.stack([torch.as_tensor(r[i]) for r in rows]) \
                .cpu().numpy().astype(np.int32)

        bf = stacked(2)
        return StepTrace(active_vertices=stacked(0),
                         active_tiles=stacked(1), blocks_fetched=bf,
                         blocks_skipped=np.int32(nb) - bf,
                         converged=np.stack([r[3] for r in rows]),
                         step_wall_s=np.asarray(walls, dtype=np.float64))

    # -------------------------------------------------------------- #
    def execute(self, srcs, *, warm: WarmStart | None = None,
                distributed: bool = False, mesh=None,
                trace: bool | int = False, max_steps=None,
                deadline_s=None, detail: bool = False):
        """Run the fixpoint from `srcs`: a scalar source is a solo query
        (`(n,)` result, int steps), a sequence a batch (`(B, n)` /
        `(B,)`). `warm` resumes from a prior converged result (see
        `WarmStart` / `resolve_warm`). `distributed=True` runs the
        distributed fixpoint over the process group `mesh` (see
        `_execute_distributed`); it refuses `trace` and `deadline_s`, as
        the reference's does. Results are bit-identical across batching,
        distribution and warm starts. `trace` (True = the default
        `TRACE_CAP_DEFAULT` rows, an int = that capacity) records
        per-step stats and makes the call return ``(out, steps,
        DispatchTelemetry)``; results are bit-identical either way.
        `max_steps` (int or (B,) ints) caps each query's steps below
        `self.max_steps`; `deadline_s` (relative seconds, scalar or
        (B,)) stops a query at the first step boundary past its
        deadline. Returns ``(out, steps)``, or an `ExecutionDetail` with
        `detail=True`."""
        batched = bool(np.ndim(srcs))
        srcs = np.atleast_1d(np.asarray(srcs, dtype=np.int64))
        budgets = self._resolve_budgets(max_steps, len(srcs))
        deadlines_t = self._resolve_deadlines(deadline_s, len(srcs))
        if distributed:
            if trace:
                raise ValueError(
                    "per-step tracing is not supported on the "
                    "distributed fixpoint yet; run the trace on a local "
                    "plan")
            if deadlines_t is not None:
                raise InvalidRequest(
                    "deadline_s is not supported on the distributed "
                    "fixpoint: use max_steps, or run on a local plan")
            out, steps, conv = self._execute_distributed(
                srcs, warm=warm, mesh=mesh, budgets=budgets)
            tele, expired = None, np.zeros(len(srcs), dtype=bool)
        else:
            out, steps, tele, conv, expired = self._execute_local(
                srcs, warm=warm, trace_cap=self._trace_cap(trace),
                budgets=budgets, deadlines_t=deadlines_t)
        if detail:
            if batched:
                return ExecutionDetail(attrs=out, steps=steps,
                                       converged=conv,
                                       deadline_expired=expired,
                                       telemetry=tele)
            return ExecutionDetail(attrs=out[0], steps=int(steps[0]),
                                   converged=bool(conv[0]),
                                   deadline_expired=bool(expired[0]),
                                   telemetry=tele)
        r = (out, steps) if batched else (out[0], int(steps[0]))
        return r + (tele,) if trace else r

    def _execute_local(self, srcs, warm: WarmStart | None = None,
                       trace_cap: int = 0, budgets=None,
                       deadlines_t=None):
        """The fixpoint over a (B,) source array; always batched.
        Returns ``(out, steps, DispatchTelemetry | None, converged,
        deadline_expired)``."""
        attrs0, aux0, frontier0 = self.initial_state(srcs, warm=warm)
        t0 = time.perf_counter()
        attrs, aux, _, steps, rec, converged, expired = self._fixpoint(
            attrs0, aux0, frontier0, trace_cap, budgets=budgets,
            deadlines_t=deadlines_t)
        out = self.finalize_state(attrs, aux)
        tele = None
        if rec is not None:
            trace, truncated = rec
            tele = DispatchTelemetry(
                backend=resolve_relax_mode(self.relax_mode, self.device),
                mode=self.mode, compact=self._use_compact,
                batch=int(steps.shape[0]), n=self.bg.n,
                ntiles=self.bg.ntiles, n_blocks=int(self.bg.bsrc.shape[0]),
                steps=steps, trace=trace,
                wall_s=time.perf_counter() - t0, truncated=truncated,
                tile=self.bg.tile, feature_dim=self.feature_dim)
        return out, steps, tele, converged, expired

    # -------------------------------------------------------------- #
    # deprecated pre-api entry points: thin shims over `execute`
    # -------------------------------------------------------------- #
    @staticmethod
    def _warn_legacy(name: str) -> None:
        warnings.warn(
            f"FlipEngine.{name} is deprecated; compile a session with "
            "flip_torch.compile(graph, program, plan) (repro_torch.api) "
            "and call .query(...), or drive FlipEngine.execute directly",
            DeprecationWarning, stacklevel=3)

    def run(self, src: int = 0, warm: WarmStart | None = None):
        """Deprecated: `execute(src)`. One query's result in original
        vertex order and its steps."""
        self._warn_legacy("run")
        return self.execute(int(src), warm=warm)

    def run_batch(self, srcs, warm: WarmStart | None = None):
        """Deprecated: `execute(srcs)` with a sequence: ((B, n) results,
        (B,) steps)."""
        self._warn_legacy("run_batch")
        return self.execute(np.atleast_1d(np.asarray(srcs)), warm=warm)

    def run_distributed(self, src=0, mesh=None, axis: str = "data",
                        warm: WarmStart | None = None):
        """Deprecated: `execute(src, distributed=True, mesh=mesh)`; shapes
        follow `src` as in `execute`. `axis` is the reference's mesh axis
        name: a process group is one axis, so it selects nothing."""
        del axis
        self._warn_legacy("run_distributed")
        return self.execute(src, warm=warm, distributed=True, mesh=mesh)

    def run_updated(self, src, prev, delta: UpdateDelta):
        """Deprecated: `execute(src, warm=resolve_warm(prev, delta))`:
        recompute after `apply_updates`, warm where sound."""
        self._warn_legacy("run_updated")
        return self.execute(src, warm=self.resolve_warm(prev, delta))

    # -------------------------------------------------------------- #
    # the distributed fixpoint
    # -------------------------------------------------------------- #
    def _execute_distributed(self, srcs, warm: WarmStart | None = None,
                             mesh=None, budgets=None):
        """The fixpoint over a (B,) source array with the destination
        tiles split over the ranks of a `torch.distributed` process
        group and the queries replicated; always batched. The port of
        the reference's shard_map fixpoint (`repro.core.engine`
        `_execute_distributed`). `mesh` is the group; None means the
        default group when one is initialised, else one rank on the
        engine's device with no collective. A group is one axis, so the
        reference's `mesh_axis` has no counterpart.

        The tiles are padded to ``ntiles_p = ceil(ntiles / world) *
        world``; rank r owns tiles ``[r*tpd, (r+1)*tpd)`` and, the blocks
        being sorted by destination, one contiguous slab of them
        (`_rank_slab`). Each step every rank computes `scatter_carry` on
        the replicated state, relaxes its slab (K1 on the card, the plain
        version on the CPU), all-gathers the new slabs -- one collective
        per step whatever B, FLIP's NoC scatter -- and applies
        `post_step`, the live mask and the budgets as the local loop
        does (`RankStep`). Every rank holds the same state, so every rank
        reads the same summary and leaves on the same step. On a CUDA
        engine over NCCL, or with no group, the steps run on the device
        loop, the all-gather captured in its CUDA graphs, one read per
        chunk (the reference's `dist_fix`); over gloo on the host loop,
        one read per step.

        Returns ``(out, steps, converged)``."""
        step = self._dist_step(mesh)
        attrs, aux, frontier = step.pad(self,
                                        self.initial_state(srcs, warm=warm))
        attrs, aux, _, steps, _, converged, _ = self._fixpoint(
            attrs, aux, frontier, 0, budgets=budgets, step=step)
        nt = self.bg.ntiles
        out = self.finalize_state(attrs[:, :nt], aux[:, :nt])
        return out, steps, converged

    def _dist_step(self, group=None) -> RankStep:
        """This rank's `RankStep` over `group` (None: the default group
        when one is initialised, else one rank with no collective)."""
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        return RankStep(self._rank_slab(rank, world), rank, world, group)

    def _rank_slab(self, rank: int, world: int) -> BlockedGraph:
        """Rank `rank`'s share of the layout, on the state's device: a
        `BlockedGraph` of its `tpd` destination tiles (`ntiles` = tpd,
        `bdst` and `dst_start` local to the slab, `bsrc` global tile
        ids). Padding tiles own no block, so a rank whose tiles are all
        padding gets an empty slab. Only the slab's blocks are copied;
        built once per (rank, world) for this engine."""
        slab = self._slabs.get((rank, world))
        if slab is not None:
            return slab
        bg, dev = self.bg, self.device
        tpd = -(-bg.ntiles // world)
        ds = bg.dst_start.cpu().numpy().astype(np.int64)
        t0 = min(rank * tpd, bg.ntiles)
        t1 = min((rank + 1) * tpd, bg.ntiles)
        s, e = int(ds[t0]), int(ds[t1])
        local = np.concatenate([ds[t0:t1 + 1],
                                np.full(tpd - (t1 - t0), ds[t1])]) - s
        slab = BlockedGraph(
            n=bg.n, tile=bg.tile, ntiles=tpd,
            blocks=bg.blocks[s:e].to(dev), bsrc=bg.bsrc[s:e].to(dev),
            bdst=(bg.bdst[s:e] - rank * tpd).to(dev), perm=bg.perm,
            inv_perm=bg.inv_perm, algebra=bg.algebra,
            dst_start=torch.from_numpy(local.astype(np.int32)).to(dev),
            version=bg.version, graph_fp=bg.graph_fp)
        self._slabs[(rank, world)] = slab
        return slab

    def _trace_cap(self, trace: bool | int) -> int:
        """0 (off) or the per-step trace row capacity."""
        if not trace:
            return 0
        cap = TRACE_CAP_DEFAULT if trace is True else int(trace)
        return max(1, min(cap, self.max_steps))

    def resolve_warm(self, prev, delta: UpdateDelta) -> WarmStart | None:
        """Warm-start dispatch after `apply_updates`: a `delta.monotone`
        batch on a monotone algebra may resume from `prev` with only
        `delta.affected_src` seeded active; anything else must recompute
        from scratch (returns None)."""
        if delta.monotone and self.algebra.kind == "monotone":
            return WarmStart(attrs=np.asarray(prev, dtype=np.float32),
                             seeds=delta.affected_src)
        return None

    def apply_updates(self, new_graph: Graph,
                      updates) -> tuple["FlipEngine", UpdateDelta]:
        """Incremental re-block after a mutation batch (`new_graph` is
        ``graph.apply_updates(updates)``): only the touched tiles are
        rebuilt (`BlockedGraph.apply_updates`). Returns ``(new_engine,
        delta)``; this engine is left untouched."""
        bg2, delta = self.bg.apply_updates(new_graph, updates)
        return dataclasses.replace(self, bg=bg2, _slabs={}), delta

    # -------------------------------------------------------------- #
    # bounded-segment stepping: the continuous-batching yield surface
    # -------------------------------------------------------------- #
    def idle_state(self, b: int):
        """(B, ntiles, T[, d]) state on the device with every lane inert:
        ⊕-identity attrs, zero aux, empty frontier. The live mask freezes
        an inert lane, so it costs nothing and perturbs no other lane."""
        bg = self.bg
        shape = (b, bg.ntiles, bg.tile)
        if self._features:
            shape = shape + (self.feature_dim,)
        return (torch.full(shape, self.algebra.semiring.zero,
                           dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros((b, bg.ntiles, bg.tile), dtype=torch.bool,
                            device=self.device))

    def write_slot(self, state, b: int, src: int,
                   warm: WarmStart | None = None):
        """Admit one query into lane `b`: returns a new state whose lane
        `b` is the freshly initialized (or warm-resumed) solo state of
        `src`; the given state is left as it was. Every fixpoint
        operation is independent along the batch axis, so the lane then
        evolves exactly as a solo run of `src`."""
        one = self.initial_state([int(src)], warm=warm)
        out = []
        for x, x1 in zip(state, one):
            x = x.clone()
            x[b] = x1[0]
            out.append(x)
        return tuple(out)

    def run_segment(self, state, budgets):
        """Advance a (B, ...) fixpoint state by a bounded segment: lane
        `b` runs at most ``budgets[b]`` further steps (0 = frozen) and
        stops early once its frontier empties. Between segments the host
        can retire converged lanes, admit queued queries and enforce
        deadlines, then re-enter with the same state.

        Returns ``(state, steps, converged)``: the advanced (attrs, aux,
        frontier), the (B,) steps taken this segment and the (B,)
        end-of-segment convergence mask (idle lanes read True). Exact:
        every step is `_masked_step`, so K-step segments compose into
        the single-call fixpoint bit for bit."""
        attrs, aux, frontier = state
        attrs, aux, frontier, steps, _, converged, _ = self._fixpoint(
            attrs, aux, frontier, 0,
            budgets=np.asarray(budgets, dtype=np.int32))
        return (attrs, aux, frontier), steps, converged

    def finalize_state(self, attrs, aux) -> np.ndarray:
        """A tiled state -> original-vertex-order numpy results:
        (B, ntiles, T[, d]) -> (B, n[, d]). Lane-independent, so a
        rotating batch finalizes one lane by slicing ``attrs[b:b+1]``."""
        with span("flip.finalize"):
            return self.bg.to_orig(self.algebra.finalize(attrs, aux),
                                   features=self._features)

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
