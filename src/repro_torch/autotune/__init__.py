"""Plan autotuner: measured-cost-model design-space exploration that
picks `ExecutionPlan` knobs per (graph, algebra, device).

The port of `repro.autotune`. Entry points:

  * `autotune(graph, program, device=...)` -- one full tune, returns a
    `TuneReport`
  * `ExecutionPlan.auto(tuned=True)` via `flip_torch.compile` -- the
    session surface; consults the `TuningStore` so tuning amortizes
  * `python -m repro_torch.launch.autotune` / `graph_run --autotune` --
    the CLI surface

Tuning is policy, never semantics: every candidate the sweep can emit
answers exactly as the default plan does (see
`repro_torch.autotune.space`). On a CUDA device every candidate is
priced by timing real fixpoint segments through the frontier-relax
kernel.
"""
from repro_torch.autotune.measure import (Sample, analytic_step_us,
                                          measure_plan, price_candidate)
from repro_torch.autotune.model import CostModel, load_bench_samples
from repro_torch.autotune.profile import GraphProfile, profile_graph
from repro_torch.autotune.space import Candidate, candidate_plans
from repro_torch.autotune.store import TuningStore, default_store_path
from repro_torch.autotune.tuner import TuneReport, autotune, resolve_tuned

__all__ = [
    "GraphProfile", "profile_graph",
    "Candidate", "candidate_plans",
    "Sample", "measure_plan", "price_candidate", "analytic_step_us",
    "CostModel", "load_bench_samples",
    "TuningStore", "default_store_path",
    "TuneReport", "autotune", "resolve_tuned",
]
