"""Dispatch failure classification and the per-dispatch NaN guard.

The part of `repro.resilience.degrade` the continuous-batching scheduler
needs. `classify` maps an arbitrary dispatch exception onto the typed
taxonomy (`repro_torch.resilience.errors`), and `finite_guard` is the
cheap result check: a NaN anywhere in the attrs means poisoned weights
or a broken kernel, never a legitimate algebra value (the semirings use
±inf sentinels, not NaN).

The reference's `fallback_chain` (its exact degradation ladder) is not
ported here: on the card its rung 1 would be the plain version on CUDA
tensors, which the port forbids. What the port's rungs are on the card
is decided with the bucket server (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import numpy as np

from repro_torch.resilience.errors import BackendFailure, FlipError


def classify(exc: BaseException, rung: int = 0) -> FlipError:
    """Map a dispatch-time exception to its typed form. A `FlipError`
    passes through; anything else a backend can raise mid-dispatch (a
    CUDA error, OOM, a failed kernel build) becomes a retryable
    `BackendFailure` with the original exception chained as `cause`."""
    if isinstance(exc, FlipError):
        return exc
    return BackendFailure(
        f"dispatch failed on rung {rung}: {type(exc).__name__}: {exc}",
        rung=rung, cause=exc)


def finite_guard(attrs) -> None:
    """Raise a retryable `BackendFailure` if any entry of a result block
    is NaN. ±inf is legitimate (the ⊕-identity of min_plus/max_min
    marks unreachable vertices); NaN is in no registered semiring's
    domain. One `np.isnan().any()` pass over the (B, n[, d]) result."""
    a = np.asarray(attrs)
    if np.isnan(a).any():
        bad = int(np.isnan(a).sum())
        raise BackendFailure(
            f"finite guard: {bad} NaN entr{'y' if bad == 1 else 'ies'} "
            f"in a {a.shape} result block (poisoned weights or kernel "
            "fault)", cause=None)
