"""repro_torch.resilience: the serving layer's failure model.

The port of `repro.resilience`:

  * `errors`  -- the typed taxonomy (`FlipError` and its five
    subclasses) every failure maps onto; requests carry their error,
    buckets and streams never die with them;
  * `degrade` -- the validated degradation ladder (relax_mode ->
    'torch', compact -> dense, each rung resolved for the session's
    device: on the card both rungs launch the CUDA kernel), exception
    classification, and the per-dispatch NaN finite guard;
  * `faults`  -- deterministic, seeded fault injection (backend raise,
    NaN-poisoned results, step stalls) driving the chaos tests.
"""
from repro_torch.resilience.degrade import (classify, fallback_chain,
                                            finite_guard)
from repro_torch.resilience.errors import (BackendFailure, CapacityExceeded,
                                           ConvergenceFailure,
                                           DeadlineExceeded, FlipError,
                                           InvalidRequest)
from repro_torch.resilience.faults import (FaultInjector, FaultSpec,
                                           InjectedFault)

__all__ = ["FlipError", "InvalidRequest", "CapacityExceeded",
           "DeadlineExceeded", "ConvergenceFailure", "BackendFailure",
           "fallback_chain", "classify", "finite_guard",
           "FaultInjector", "FaultSpec", "InjectedFault"]
