"""Candidate pricing: measured fixpoint segments, analytic fallback.

The port of `repro.autotune.measure`. Two pricing paths, one currency
(microseconds per relaxation step per query):

  * **measured** -- the ground truth. A candidate plan is built into a
    real `FlipEngine` on the session's device and driven through the
    engine's bounded-segment surface (`run_segment`, the hook the
    continuous-batching scheduler uses): a few deterministic probe
    sources, a capped step budget, best-of-`repeats` wall time. On a
    CUDA device every step is one launch of the frontier-relax kernel,
    and each repeat is bracketed by `torch.cuda.synchronize()` and CUDA
    events; `run_segment` reads the frontier back once per step, so the
    events span the host-bound wall a user feels.

  * **analytic** -- the cycle-simulator bridge, for candidates whose
    measurement would blow the tuning budget. The estimate reuses the
    cost vocabulary of `core/sim.py` (`FlipArch.t_tab`, the clock):
    per streamed block T*T*d MAC-equivalents plus a per-delivered-row
    processing term, scaled by the route's relative throughput. Only
    its *ordinal* honesty matters (dense > compacted at sparse
    frontiers, cost grows with streamed volume). Its block count
    assumes random edge placement (`expected_blocks`), which on a road
    network overestimates the real blocks many times over.

Every sample records which path priced it (`source`). A measurement
that raises degrades to the analytic price on the CPU, as in the
reference; on a CUDA device it re-raises, since a kernel that fails to
build or launch must never turn into an analytic number.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.program import Program
from repro_torch.autotune.profile import GraphProfile
from repro_torch.core.arch import DEFAULT_ARCH, FlipArch
from repro_torch.core.engine import FlipEngine
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph

# measurement defaults: a handful of sources x a short exact segment
PROBE_SOURCES = 4
SEGMENT_STEPS = 8
REPEATS = 3

# analytic-bridge constants (the reference's): the default instruction
# cycles per update-carrying vertex execution (paper Sec. 3; each
# algebra carries its own `exe_update`) and the relative throughput of
# the routes on one step's identical math. The CUDA kernel takes the
# reference's Pallas factor, the plain version jnp's.
EXE_UPDATE_CYCLES = 5
BACKEND_FACTOR = {"cuda": 0.25, "torch": 1.0}
MAC_PER_CYCLE = 64.0          # vectorized lanes per clock, plain baseline
STEP_FIXED_CYCLES = 2_000.0   # per-step dispatch overhead


@dataclasses.dataclass(frozen=True)
class Sample:
    """One priced candidate: the tuner's unit of evidence.

    `features` optionally pins the cost-model regressor vector the
    sample was observed under -- bench-history rows come from *other*
    graphs, so their regressors cannot be recomputed from the current
    profile (see `repro_torch.autotune.model`)."""
    plan: ExecutionPlan
    step_us: float          # microseconds per relaxation step per query
    steps: int              # steps actually executed (measured path)
    wall_s: float           # total harness wall (measured path)
    source: str             # 'measured' | 'analytic'
    features: tuple | None = None   # (1, blocks, volume) when pinned

    def to_json(self) -> dict:
        p = self.plan
        return {"tile": p.tile, "relax_mode": p.relax_mode,
                "compact": bool(p.compact), "batch": p.batch,
                "mode": p.mode, "step_us": round(self.step_us, 3),
                "steps": self.steps, "wall_s": round(self.wall_s, 6),
                "source": self.source}


def probe_sources(graph: Graph, seed: int,
                  count: int = PROBE_SOURCES) -> np.ndarray:
    """Deterministic probe sources: seeded draws without replacement
    (the whole tune is a pure function of (graph, plan space, seed))."""
    rng = np.random.default_rng(seed)
    count = max(1, min(count, graph.n))
    return np.sort(rng.choice(graph.n, size=count, replace=False)
                   .astype(np.int64))


def _timed_segment(eng: FlipEngine, srcs, budgets) -> tuple[float, int]:
    """One segment from a fresh initial state: (wall seconds, steps
    summed over the probe queries). CUDA events on a CUDA device, the
    host clock on the CPU."""
    state = eng.initial_state(srcs)
    if eng.device.type != "cuda":
        t0 = time.perf_counter()
        _, steps, _ = eng.run_segment(state, budgets)
        return time.perf_counter() - t0, int(np.sum(steps))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(eng.device)
    start.record()
    _, steps, _ = eng.run_segment(state, budgets)
    end.record()
    torch.cuda.synchronize(eng.device)
    return start.elapsed_time(end) * 1e-3, int(np.sum(steps))


def engine_key(plan: ExecutionPlan) -> tuple:
    """The knobs `measure_plan` builds its engine from. Candidates that
    differ only in serving bucket width (`batch`) share one engine and
    run the same segments, so one measurement prices them all."""
    return (plan.tile, plan.mode, plan.relax_mode, plan.compact,
            plan.feature_dim)


def measure_plan(graph: Graph, program, plan: ExecutionPlan, *,
                 seed: int = 0, sources: int = PROBE_SOURCES,
                 segment_steps: int = SEGMENT_STEPS,
                 repeats: int = REPEATS, device=None) -> Sample:
    """Price one resolved plan by running real capped segments on
    `device` (default: the CUDA device; raises without one).

    Builds the candidate's engine directly (never through `compile`,
    which could re-enter the tuner) and times `run_segment` over the
    probe batch: one untimed segment warms the kernel, then each timed
    repeat re-enters from a fresh initial state so every repeat
    measures the same steps. Best-of-repeats guards against scheduler
    noise; the per-step normalization divides by the steps the engine
    actually took."""
    prog = Program.of(program)
    eng = FlipEngine.build(
        graph, prog.algebra, tile=plan.tile, mode=plan.mode,
        relax_mode=plan.relax_mode, compact=plan.compact,
        feature_dim=plan.feature_dim,
        device=resolve_device(device, "measure_plan"))
    srcs = probe_sources(graph, seed, sources)
    budgets = np.full(len(srcs), segment_steps, dtype=np.int32)
    eng.run_segment(eng.initial_state(srcs), budgets)   # warm the kernel
    best, steps_total = math.inf, 1
    for _ in range(max(1, repeats)):
        wall, steps = _timed_segment(eng, srcs, budgets)
        if wall < best:
            best = wall
            steps_total = max(1, steps)
    return Sample(plan=plan, step_us=best * 1e6 / steps_total,
                  steps=steps_total, wall_s=best, source="measured")


# ------------------------------------------------------------------ #
# the cycle-sim bridge
# ------------------------------------------------------------------ #
def expected_blocks(n: int, m: int, tile: int) -> float:
    """Expected non-empty (src tile, dst tile) weight blocks when m
    edges land at random over the tile grid -- the occupancy of
    ntiles^2 cells under m throws, smooth and deterministic."""
    ntiles = max(1, -(-n // tile))
    cells = float(ntiles * ntiles)
    return cells * -math.expm1(m * math.log1p(-1.0 / cells)) \
        if cells > 1 else 1.0


def active_tile_fraction(density: float, tile: int) -> float:
    """P(a tile holds >= 1 active vertex) at per-vertex density p --
    the kernel's packet-trigger probability, which is what compaction
    actually skips on."""
    p = min(max(density, 0.0), 1.0)
    return float(-math.expm1(tile * math.log1p(-p))) if p < 1.0 else 1.0


def analytic_step_us(profile: GraphProfile, plan: ExecutionPlan,
                     arch: FlipArch = DEFAULT_ARCH,
                     exe_update: int = EXE_UPDATE_CYCLES) -> float:
    """Per-step cost estimate for one query, in model-microseconds.

    The Algorithm-2 shape from `RuntimeEstimator.edge_time`, applied
    at block granularity: each streamed block costs its T*T*d
    MAC-equivalents (throughput `MAC_PER_CYCLE`/cycle) plus a
    per-delivered-row processing term (`t_tab + exe_update` cycles),
    converted at the arch clock and scaled by the route's relative
    throughput. Compaction prices only the expected active blocks;
    dense streaming prices them all."""
    t, d = plan.tile, max(profile.feature_dim, 1)
    nb = expected_blocks(profile.n, profile.m, t)
    af = active_tile_fraction(profile.mean_density, t)
    fetched = nb * (af if plan.compact else 1.0)
    mac_cycles = fetched * t * t * d / MAC_PER_CYCLE
    proc_cycles = fetched * t * (arch.t_tab + exe_update) \
        / MAC_PER_CYCLE
    cycles = mac_cycles + proc_cycles + STEP_FIXED_CYCLES
    return BACKEND_FACTOR.get(plan.relax_mode, 1.0) * cycles \
        / arch.freq_mhz


def estimated_measure_s(profile: GraphProfile, plan: ExecutionPlan, *,
                        sources: int = PROBE_SOURCES,
                        segment_steps: int = SEGMENT_STEPS,
                        repeats: int = REPEATS) -> float:
    """Predicted wall cost of *measuring* this candidate -- what the
    budget gate compares against before committing to a real run."""
    per_step = analytic_step_us(profile, plan) * 1e-6
    return per_step * segment_steps * max(1, sources) * (repeats + 1)


def price_candidate(graph: Graph, program, plan: ExecutionPlan,
                    profile: GraphProfile, *, measure_ok: bool = True,
                    seed: int = 0, budget_s: float | None = None,
                    sources: int = PROBE_SOURCES,
                    segment_steps: int = SEGMENT_STEPS,
                    repeats: int = REPEATS,
                    arch: FlipArch = DEFAULT_ARCH,
                    device=None) -> Sample:
    """Measured when allowed and affordable, analytic otherwise.

    On the CPU a measurement that fails outright degrades to the
    analytic estimate rather than killing the sweep, as in the
    reference. On a CUDA device it raises: a kernel that does not build
    or launch is a fault to report, not a price."""
    exe = Program.of(program).algebra.exe_update
    if measure_ok and (budget_s is None or estimated_measure_s(
            profile, plan, sources=sources,
            segment_steps=segment_steps, repeats=repeats) <= budget_s):
        device = resolve_device(device, "price_candidate")
        try:
            return measure_plan(graph, program, plan, seed=seed,
                                sources=sources,
                                segment_steps=segment_steps,
                                repeats=repeats, device=device)
        except Exception:
            if device.type == "cuda":
                raise
    return Sample(plan=plan,
                  step_us=analytic_step_us(profile, plan, arch,
                                           exe_update=exe),
                  steps=0, wall_s=0.0, source="analytic")
