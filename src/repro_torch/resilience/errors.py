"""Typed error taxonomy for the serving layer.

Every failure a request can experience maps to exactly one `FlipError`
subclass, so the serving front-end can (a) attach the failure to the
request that caused it instead of losing the whole bucket, (b) decide
mechanically whether a retry down the degradation ladder can help
(`retryable`), and (c) export failure counts per `code` without string
matching. The taxonomy (see docs/RESILIENCE.md):

  FlipError
  ├─ InvalidRequest       caller error (bad source, bad budget); also a
  │                       ValueError so pre-taxonomy `except ValueError`
  │                       call sites keep working
  ├─ CapacityExceeded     admission control shed the request (queue
  │                       depth / per-algo quota) — retry later
  ├─ DeadlineExceeded     the request's deadline expired (in queue, or
  │                       mid-fixpoint with a partial result attached)
  ├─ ConvergenceFailure   the fixpoint hit its step budget without
  │                       converging — the result is a flagged partial,
  │                       never silently-truncated garbage
  └─ BackendFailure       the execution backend raised (pallas off-TPU,
                          retrace failure, OOM, non-finite guard trip):
                          retryable down the degradation ladder

`code` is the stable machine-readable identifier (metric names, JSON
exports); the message is for humans.
"""
from __future__ import annotations


class FlipError(Exception):
    """Base of every typed serving-layer failure."""

    code = "flip_error"
    #: a retry on a degraded rung (jnp / dense streaming) may succeed
    retryable = False

    def describe(self) -> dict:
        """JSON-ready view: stable code, class name, human message."""
        return {"code": self.code, "type": type(self).__name__,
                "message": str(self)}


class InvalidRequest(FlipError, ValueError):
    """The request itself is malformed: out-of-range source, negative
    budget, unknown algorithm. Never retried -- no backend can make an
    out-of-range vertex id valid."""

    code = "invalid_request"

    def __init__(self, message: str, *, value=None):
        super().__init__(message)
        self.value = value


class CapacityExceeded(FlipError):
    """Admission control rejected the request: the bounded queue (or the
    algebra's quota) is full. Shed at submit time -- reject-newest -- so
    accepted requests keep their latency instead of everyone timing
    out."""

    code = "capacity_exceeded"

    def __init__(self, message: str, *, depth: int = 0, limit: int = 0):
        super().__init__(message)
        self.depth = depth
        self.limit = limit


class DeadlineExceeded(FlipError):
    """The request's deadline budget expired: either before dispatch
    (still queued -- no work was done) or at a fixpoint step boundary
    (a partial, non-converged result is attached to the request)."""

    code = "deadline_exceeded"

    def __init__(self, message: str, *, deadline_s: float = 0.0,
                 elapsed_s: float = 0.0, where: str = ""):
        super().__init__(message)
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s
        #: "" (bucket server), "queue" (expired before any work), or
        #: "fixpoint" (expired mid-relaxation, partial attached) --
        #: the scheduler's SLO accounting splits on this
        self.where = where

    def describe(self) -> dict:
        d = super().describe()
        if self.where:
            d["where"] = self.where
        return d


class ConvergenceFailure(FlipError):
    """The fixpoint stopped at its step budget with a non-empty
    frontier. The attrs are a valid partial relaxation (every relaxation
    performed is real), but NOT the fixpoint -- callers must see the
    flag, never mistake the partial for an answer."""

    code = "convergence_failure"

    def __init__(self, message: str, *, steps=None, max_steps=None):
        super().__init__(message)
        self.steps = steps
        self.max_steps = max_steps


class BackendFailure(FlipError):
    """The execution backend raised (or the per-dispatch finite guard
    tripped). Retryable: rung N+1 of the degradation ladder (pallas→jnp,
    compact→dense) runs the same exact fixpoint on a simpler path."""

    code = "backend_failure"
    retryable = True

    def __init__(self, message: str, *, rung: int = 0,
                 cause: BaseException | None = None):
        super().__init__(message)
        self.rung = rung
        self.cause = cause
