"""repro_torch.resilience: the serving layer's failure model.

  * `errors`  -- the typed taxonomy (a copy of `repro.resilience.errors`);
  * `degrade` -- `classify` and the NaN `finite_guard`, what the
    continuous-batching scheduler needs.

The reference's degradation ladder (`fallback_chain`) and fault
injection (`faults.py`) come with the bucket server (ROADMAP Queue 1
item 5).
"""
from repro_torch.resilience.degrade import classify, finite_guard
from repro_torch.resilience.errors import (BackendFailure, CapacityExceeded,
                                           ConvergenceFailure,
                                           DeadlineExceeded, FlipError,
                                           InvalidRequest)

__all__ = ["FlipError", "InvalidRequest", "CapacityExceeded",
           "DeadlineExceeded", "ConvergenceFailure", "BackendFailure",
           "classify", "finite_guard"]
