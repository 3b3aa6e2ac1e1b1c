"""The legal plan design space: every candidate the tuner may pick.

The port of `repro.autotune.space`. One rule keeps the tuner honest: *a
candidate is legal iff `ExecutionPlan.resolve(algebra, device)` accepts
it*. The space enumerates the performance-only knobs -- tile size, the
relax route, frontier compaction, serving bucket width -- and funnels
every combination through the validation the session front door
applies, so a plan the tuner emits is a plan `compile` would have
accepted.

Knobs the space deliberately does NOT explore (as in the reference):

  * `mode` ('data' vs 'op') and `warm`: policy contracts with the
    caller, kept at the base plan's setting;
  * `feature_dim`: the program's native width is semantics;
  * K1's launch plan (`kernels.frontier.frontier.launch_plan`: ring,
    split, blocks an SM), which the kernel's wrapper derives from the
    shapes: the reference does not tune its kernel's launch shape
    either.

The knob restriction that keeps "bit-exact" honest is the reference's:
`tile` and the route only vary when the algebra's ⊕ is *idempotent*
(min / max / or). Re-tiling regroups the per-destination reduction --
bitwise inert for an idempotent merge, a few-ulp drift for pagerank /
labelprop's float +. For those algebras the sweep varies only `compact`
and `batch`.

Routes per device: the CUDA kernel on a CUDA device, the plain version
on the CPU (each device has exactly one legal route, so the route never
varies; the port has no interpret route and so no analytic-only
candidate). On the cuda route `compact` is a no-op -- the kernel skips
an inactive source tile per query whatever the flag says -- so on a
CUDA device the space keeps `compact` at the base plan's value and
varies only `tile` and `batch`; on the CPU it varies `tile`, `compact`
and `batch`, as the reference does for its jnp route.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.device import resolve_device

TILES = (64, 128, 256)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One legal plan. Every route of the port can be measured, so
    unlike the reference's candidate it carries no analytic-only flag."""
    plan: ExecutionPlan          # resolved (no 'auto' left)

    @property
    def key(self) -> tuple:
        return self.plan.key()


def _relax_candidates(device: torch.device) -> tuple[str, ...]:
    """The route legal on `device`: the kernel on a CUDA device, the
    plain version on the CPU."""
    return ("cuda" if device.type == "cuda" else "torch",)


def _compact_candidates(base: ExecutionPlan, device: torch.device) -> tuple:
    """`compact` values worth sweeping: both on the CPU's plain version;
    the base plan's alone on a CUDA device, where the kernel ignores the
    flag (module doc)."""
    return (base.compact,) if device.type == "cuda" else (True, False)


def _batch_candidates(base_batch: int) -> tuple[int, ...]:
    """Bucket widths around the base plan's serving batch: a solo plan
    (batch=0) stays solo, while a serving plan explores halving and
    doubling its bucket."""
    if base_batch <= 0:
        return (0,)
    return tuple(sorted({max(1, base_batch // 2), base_batch,
                         base_batch * 2}))


def candidate_plans(base: ExecutionPlan, algebra=None,
                    device=None) -> list[Candidate]:
    """Enumerate the legal candidates around `base` on `device`
    (default: the CUDA device; raises without one).

    Every returned candidate has passed `ExecutionPlan.resolve(algebra,
    device)` -- combinations the validator rejects (compact=True with
    mode='op', ...) are skipped. The base plan's own resolved form
    always leads the list, so the tuner's argmin can never pick
    something worse than the static default."""
    device = resolve_device(device, "candidate_plans")
    seen: set[tuple] = set()
    out: list[Candidate] = []
    exact_regroup = (algebra is None
                     or algebra.semiring.idempotent)
    tiles = TILES if exact_regroup else (base.tile,)
    relaxes = (_relax_candidates(device) if exact_regroup
               else (base.relax_mode,))
    combos = [(t, r, c, b)
              for t in tiles
              for r in relaxes
              for c in _compact_candidates(base, device)
              for b in _batch_candidates(base.batch)]
    # the static default (base as-is) leads the list so ties break to it
    probes = [base] + [
        dataclasses.replace(base, tile=t, relax_mode=r, compact=c,
                            batch=b, tuned=False)
        for (t, r, c, b) in combos]
    for plan in probes:
        try:
            resolved = dataclasses.replace(plan, tuned=False).resolve(
                algebra, device)
        except (ValueError, TypeError):
            continue
        k = resolved.key()
        if k in seen:
            continue
        seen.add(k)
        out.append(Candidate(plan=resolved))
    return out
