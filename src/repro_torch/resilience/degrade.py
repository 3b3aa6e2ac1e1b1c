"""Degradation ladder: validated fallback plans + failure classification.

The port of `repro.resilience.degrade`. When a dispatch raises (a CUDA
error, OOM, a failed kernel build) or returns NaN, the bucket server
(`repro_torch.launch.serve_graph.GraphServer`) does not lose the bucket:
it retries once per rung down a validated chain of simpler plans, built
as the reference builds it over the port's knobs:

    rung 0   the session's own plan
    rung 1   relax_mode -> 'torch'   (the plain PyTorch version)
    rung 2   compact    -> False     (dense block streaming)

Each rung is resolved for the session's device, and a rung whose
`resolve` raises `ValueError` is skipped: later knob changes then apply
to the last rung that resolved. `ExecutionPlan.resolve` refuses
'torch' on a CUDA device, so

  * on the card the chain is [cuda + compact, cuda + dense]: both rungs
    launch the frontier-relax kernel (it always skips inactive blocks,
    so `compact` does not change what it computes) and rung 1 is an
    exact retry of the same kernel. No rung reaches the plain version
    on the card;
  * on the CPU the chain is [torch + compact, torch + dense], the shape
    of the reference's [jnp + compact, jnp + dense].

Every rung is EXACT: a degraded response is bit-for-bit the primary
one. `classify` maps an arbitrary dispatch exception onto the typed
taxonomy (`repro_torch.resilience.errors`), and `finite_guard` is the
cheap result check: a NaN anywhere in the attrs means poisoned weights
or a broken kernel, never a legitimate algebra value (the semirings use
±inf sentinels, not NaN). The kernel propagates NaN as the plain
version does, so the guard trips on the card too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.resilience.errors import BackendFailure, FlipError


def fallback_chain(plan, algebra=None, device=None) -> list:
    """The validated degradation ladder for `plan` on `device` (default:
    the CUDA device): rung 0 is the plan itself, each later rung swaps
    one knob for its simplest exact equivalent (relax_mode -> 'torch',
    then compact -> False). Every rung is `resolve()`d for the device; a
    rung that does not resolve is skipped and the next knob change
    applies to the last rung that did. Rungs equal to an earlier rung
    are dropped, so a plan already at the bottom gets a one-rung chain.
    The ladder can never trade one failure for a plan-validation
    error."""
    out, seen, cur = [], set(), plan
    for change in ({}, {"relax_mode": "torch"}, {"compact": False}):
        cand = dataclasses.replace(cur, **change)
        try:
            rung = cand.resolve(algebra, device)
        except ValueError:
            continue                      # never ladder onto a bad plan
        cur = cand
        if rung.key() not in seen:
            seen.add(rung.key())
            out.append(rung)
    return out


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
