"""The tuner: profile -> sweep -> price -> model -> chosen plan.

The port of `repro.autotune.tuner`. `autotune(graph, program)` is the
whole subsystem in one call:

  1. profile the graph (`repro_torch.autotune.profile`) and look the
     fingerprint up in the tuning store -- a hit returns instantly;
  2. enumerate the legal candidate plans around the caller's base plan
     on the session's device (`repro_torch.autotune.space`);
  3. price every candidate (`repro_torch.autotune.measure`): real capped
     `run_segment` timings where allowed and affordable (through the
     frontier-relax kernel on a CUDA device), the analytic cycle-sim
     bridge otherwise. Each distinct engine is measured once and its
     sample prices every bucket width on it (the reference times the
     same engine once per width, so its measured sweep picks the width
     by timing noise);
  4. fit the cost model over the measured samples and use it to price
     the analytic-only candidates (the reference also folds in the JAX
     package's recorded bench rows; none of them is this port's, so the
     port fits on its own sweep);
  5. pick the argmin -- any candidate within `NOISE_BAND` of the best
     loses to the *earlier* candidate in sweep order, and the sweep
     puts the caller's base plan first. The same (graph, program, base,
     seed) always tunes to the same plan in model-only mode
     (`measure=False`).

The chosen plan is pure policy: every candidate differs from the
default only in tile / route / compaction / bucket width, all exact by
the engine's contracts, so tuning can change *when* the answer arrives
but never *what* it is.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.program import Program
from repro_torch.autotune.measure import (PROBE_SOURCES, SEGMENT_STEPS,
                                          Sample, engine_key,
                                          price_candidate)
from repro_torch.autotune.model import CostModel
from repro_torch.autotune.profile import GraphProfile, profile_graph
from repro_torch.autotune.space import Candidate, candidate_plans
from repro_torch.autotune.store import TuningStore
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph

# ties within this relative band break toward the earlier (= more
# default) candidate: a 2% win is measurement noise, not evidence
NOISE_BAND = 0.02
# default wall budget for the whole measured sweep's per-candidate gate
DEFAULT_BUDGET_S = 2.0

TUNED_KNOBS = ("tile", "relax_mode", "compact", "batch")


@dataclasses.dataclass
class TuneReport:
    """One tuning outcome: what was chosen, from what evidence, why."""

    profile: GraphProfile
    chosen: ExecutionPlan          # resolved; tuned flag cleared
    samples: list                  # [Sample] -- empty on a store hit
    why: str
    cached: bool                   # True: served from the store
    seed: int
    scores: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "profile": self.profile.to_json(),
            "chosen": {k: getattr(self.chosen, k) for k in TUNED_KNOBS},
            "samples": [s.to_json() for s in self.samples],
            "why": self.why, "cached": self.cached, "seed": self.seed,
        }


def _knobs_of(plan: ExecutionPlan) -> dict:
    return {k: getattr(plan, k) for k in TUNED_KNOBS}


def _plan_from_knobs(base: ExecutionPlan, knobs: dict, algebra, device) \
        -> ExecutionPlan | None:
    """Rehydrate a stored knob dict onto the caller's base plan --
    tunable knobs only, so a stored entry can never smuggle in a
    semantics change. None when the stored combo no longer resolves on
    `device`: stale-by-environment is just another cache miss."""
    clean = {k: knobs[k] for k in TUNED_KNOBS if k in knobs}
    try:
        return dataclasses.replace(base, tuned=False, **clean) \
            .resolve(algebra, device)
    except (ValueError, TypeError, KeyError):
        return None


def _score_table(cands: list[Candidate], samples: list[Sample],
                 model: CostModel, profile: GraphProfile) -> list[float]:
    """Per-candidate cost in step-us: measured candidates score their
    own measurement; analytic-priced ones go through the fitted model
    (which itself falls back to the analytic bridge for routes the fit
    never saw)."""
    out = []
    for c, s in zip(cands, samples):
        if s.source == "measured":
            out.append(float(s.step_us))
        else:
            out.append(float(model.predict(profile, c.plan)))
    return out


def autotune(graph: Graph, program,
             base_plan: ExecutionPlan | None = None, *, seed: int = 0,
             store: TuningStore | None = None, force: bool = False,
             measure: bool = True,
             budget_s: float | None = DEFAULT_BUDGET_S,
             segment_steps: int = SEGMENT_STEPS,
             sources: int = PROBE_SOURCES, device=None) -> TuneReport:
    """Tune the ExecutionPlan knobs for (graph, program) on `device`
    (default: the CUDA device; raises without one) -- module doc.

    measure=False runs the whole sweep through the analytic model: no
    clocks anywhere, so the chosen plan is a pure deterministic function
    of (graph shape, base plan, seed). `force=True` bypasses the store
    on read (the fresh result is still written back)."""
    prog = Program.of(program)
    dev = resolve_device(device, "autotune")
    base = base_plan if base_plan is not None else ExecutionPlan()
    rbase = dataclasses.replace(base, tuned=False).resolve(prog.algebra,
                                                           dev)
    profile = profile_graph(graph, feature_dim=rbase.feature_dim,
                            device=dev)
    fp = profile.fingerprint()
    algebra_name = prog.algebra.name

    if store is not None and not force:
        entry = store.get(fp, algebra_name, profile.backend)
        if entry is not None:
            plan = _plan_from_knobs(rbase, entry["plan"], prog.algebra,
                                    dev)
            if plan is not None:
                return TuneReport(
                    profile=profile, chosen=plan, samples=[],
                    why=entry.get("why", "") or "store hit",
                    cached=True, seed=int(entry.get("seed", seed)))

    cands = candidate_plans(rbase, prog.algebra, device=dev)
    # one measurement per engine: candidates that differ only in bucket
    # width run the same segments, so they share it and score equal,
    # and the noise-band tie-break (not timing noise) picks among them
    samples, measured = [], {}
    for c in cands:
        s = measured.get(engine_key(c.plan))
        if s is None:
            s = price_candidate(graph, prog, c.plan, profile,
                                measure_ok=measure, seed=seed,
                                budget_s=budget_s, sources=sources,
                                segment_steps=segment_steps, device=dev)
            if s.source == "measured":
                measured[engine_key(c.plan)] = s
        else:
            s = dataclasses.replace(s, plan=c.plan)
        samples.append(s)
    model = CostModel.fit(samples, profile)
    scores = _score_table(cands, samples, model, profile)

    # argmin with the noise-band tie-break: the first candidate within
    # NOISE_BAND of the minimum wins, and sweep order puts the base
    # plan first -- so "barely better" never displaces the default
    best = min(scores)
    idx = next(i for i, s in enumerate(scores)
               if s <= best * (1.0 + NOISE_BAND))
    chosen, csample = cands[idx].plan, samples[idx]
    base_score = scores[0]
    why = (
        f"{csample.source} sweep over {len(cands)} candidates: "
        f"tile={chosen.tile} relax={chosen.relax_mode} "
        f"compact={chosen.compact} batch={chosen.batch} at "
        f"{scores[idx]:.1f}us/step vs default {base_score:.1f}us/step "
        f"(model fit on {model.n_samples} samples)")
    report = TuneReport(
        profile=profile, chosen=chosen, samples=samples, why=why,
        cached=False, seed=seed,
        scores={c.plan.key(): s for c, s in zip(cands, scores)})
    if store is not None:
        store.put(fp, algebra_name, profile.backend, _knobs_of(chosen),
                  score_us=scores[idx], seed=seed,
                  samples=[s.to_json() for s in samples],
                  profile_json=profile.to_json(), why=why)
    return report


def resolve_tuned(graph: Graph, program, plan: ExecutionPlan, *,
                  store: TuningStore | None = None, seed: int = 0,
                  device=None) -> tuple[ExecutionPlan, TuneReport]:
    """The session hook: collapse a ``tuned=True`` plan to its tuned
    concrete form on `device`. Consults the default store when none is
    given (so `compile(..., ExecutionPlan.auto(tuned=True))` amortizes
    across sessions), and returns the resolved chosen plan (tuned flag
    cleared) plus the report the session stamps into telemetry."""
    if store is None:
        store = TuningStore()
    report = autotune(graph, program, base_plan=plan, seed=seed,
                      store=store, device=device)
    return report.chosen, report
