"""The serving request record (a copy of `repro.serving.request`).

One `ServeRequest` per submitted query, carrying its outcome (result or
typed error -- never neither: zero lost requests is the serving-layer
invariant) plus the latency split the scheduler measured on its
injectable clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.resilience.errors import FlipError


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    algo: str
    src: int
    result: np.ndarray | None = None
    steps: int | None = None
    t_submit: float = 0.0        # clock.now() at enqueue
    queue_wait_s: float = 0.0    # enqueue -> admission into a slot
    service_s: float = 0.0       # admission -> retirement
    error: FlipError | None = None   # typed failure, if any
    converged: bool = True       # False: `result` is a flagged partial
    deadline_expired: bool = False
    max_steps: int | None = None     # per-request step budget
    deadline_s: float | None = None  # per-request budget as submitted
    t_deadline: float | None = None  # absolute deadline on the clock
    # --- continuous-batching provenance -------------------------- #
    cache_hit: bool = False      # served from the shared result cache
    warm_started: bool = False   # fixpoint resumed from a cached result
    slot: int | None = None      # rotating-batch lane that served it
    admit_window: int | None = None  # admission-window ordinal

    @property
    def done(self) -> bool:
        """Processed: the server produced a result OR a typed error.
        Every submitted request ends `done` -- nothing is ever lost."""
        return self.result is not None or self.error is not None

    @property
    def ok(self) -> bool:
        """Fully served: converged result, no error."""
        return self.result is not None and self.error is None
