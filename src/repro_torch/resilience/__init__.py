"""Typed errors of the port (a copy of `repro.resilience.errors`). The
degradation ladder and fault injection are not ported yet (ROADMAP Queue
1 item 5)."""
from repro_torch.resilience.errors import (BackendFailure, CapacityExceeded,
                                           ConvergenceFailure,
                                           DeadlineExceeded, FlipError,
                                           InvalidRequest)

__all__ = ["FlipError", "InvalidRequest", "CapacityExceeded",
           "DeadlineExceeded", "ConvergenceFailure", "BackendFailure"]
