"""ExecutionPlan: every execution knob of a query in one typed, validated
place.

The port of `repro.api.plan`. The fields keep the reference's names and
meanings; `relax_mode` names the port's routes ('auto' | 'cuda' |
'torch'). `resolve(algebra, device)` validates every combination up
front and collapses every ``"auto"``, so a resolved plan is a complete
record of how a query ran. The reference's mesh knobs (the distributed
fixpoint, ROADMAP Queue 1 item 10) are absent.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.algebra import VertexAlgebra
from repro_torch.device import resolve_device
from repro_torch.kernels.frontier.ops import RELAX_MODES, resolve_relax_mode

MODES = ("data", "op")
WARM_POLICIES = ("auto", "always", "never")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """How a compiled query executes. All fields have working defaults;
    ``"auto"`` values are collapsed by `resolve()`.

    mode        -- 'data' (FLIP packet-triggered frontier execution) or
                   'op' (classic-CGRA full sweep per step).
    relax_mode  -- 'auto' (the CUDA kernel on a CUDA device, the plain
                   PyTorch version on the CPU), 'cuda' or 'torch'.
    compact     -- frontier-compacted block streaming of the plain
                   version: True / False / 'auto' (= on for data mode).
                   The CUDA kernel always skips inactive blocks. Exact.
    tile        -- block tile size (vertices per tile).
    batch       -- serving bucket size: 0 runs any source sequence as
                   one fixpoint; B > 0 dispatches fixed-size, padded
                   buckets of B.
    warm        -- incremental-recompute policy for `query(..., warm=)`:
                   'auto' resumes from the prior result whenever sound
                   (monotone algebra + monotone update delta) and
                   recomputes from scratch otherwise; 'always' raises
                   instead of recomputing; 'never' forbids warm starts.
    feature_dim -- feature width d: 0 adopts the program's native width;
                   vector programs only run at their native width.
    max_steps   -- fixpoint safety valve.
    deadline_s  -- default per-request wall-clock budget in seconds
                   (None = unbounded), enforced at step boundaries.
    tuned       -- ask the plan autotuner (`repro_torch.autotune`) to
                   pick the performance knobs (tile / relax_mode /
                   compact / batch) for this (graph, program, device) at
                   compile time, consulting the tuning store first. Pure
                   policy: a tuned plan answers as the default does.
                   `resolve()` alone leaves the flag in place -- it has
                   no graph to tune against; `compile` is where it
                   collapses.
    """

    mode: str = "data"
    relax_mode: str = "auto"
    compact: bool | str = "auto"
    tile: int = 128
    batch: int = 0
    warm: str = "auto"
    feature_dim: int = 0
    max_steps: int = 100_000
    deadline_s: float | None = None
    tuned: bool = False

    def key(self) -> tuple:
        """Hashable cache key (session caches key on fingerprint+plan)."""
        return (self.mode, self.relax_mode, self.compact, self.tile,
                self.batch, self.warm, self.feature_dim, self.max_steps,
                self.deadline_s, self.tuned)

    @classmethod
    def auto(cls, **overrides) -> "ExecutionPlan":
        """The default plan (every knob on 'auto'), with overrides."""
        return cls(**overrides)

    def validate(self, algebra: VertexAlgebra | None = None) -> None:
        """Reject inconsistent knob combinations with one clear error.
        With `algebra`, also the algebra-dependent ones (warm='always'
        needs a monotone algebra)."""
        if self.mode not in MODES:
            raise ValueError(
                f"plan.mode must be one of {MODES}, got {self.mode!r}")
        if self.relax_mode not in RELAX_MODES:
            raise ValueError(
                f"plan.relax_mode must be one of {RELAX_MODES}, got "
                f"{self.relax_mode!r}")
        if self.compact not in (True, False, "auto"):
            raise ValueError(
                "plan.compact must be True, False, or 'auto', got "
                f"{self.compact!r}")
        if self.compact is True and self.mode == "op":
            raise ValueError(
                "plan.compact=True is inconsistent with mode='op': an "
                "op-mode sweep relaxes every block by definition -- use "
                "mode='data' or compact='auto'")
        if not isinstance(self.tile, int) or self.tile < 1:
            raise ValueError(f"plan.tile must be a positive int, got "
                             f"{self.tile!r}")
        if not isinstance(self.batch, int) or self.batch < 0:
            raise ValueError(
                f"plan.batch must be an int >= 0 (0 = one fixpoint over "
                f"the whole source sequence), got {self.batch!r}")
        if self.warm not in WARM_POLICIES:
            raise ValueError(
                f"plan.warm must be one of {WARM_POLICIES}, got "
                f"{self.warm!r}")
        if not isinstance(self.feature_dim, int) or self.feature_dim < 0:
            raise ValueError(
                f"plan.feature_dim must be an int >= 0 (0 = the "
                f"program's native width), got {self.feature_dim!r}")
        if algebra is not None and algebra.feature_dim > 1 \
                and self.feature_dim not in (0, algebra.feature_dim):
            raise ValueError(
                f"plan.feature_dim={self.feature_dim} conflicts with "
                f"{algebra.name}'s native feature_dim "
                f"{algebra.feature_dim}; vector programs only run at "
                "their native width (use feature_dim=0 to adopt it)")
        if self.max_steps < 1:
            raise ValueError(
                f"plan.max_steps must be >= 1, got {self.max_steps}")
        if self.deadline_s is not None and not (
                isinstance(self.deadline_s, (int, float))
                and self.deadline_s > 0):
            raise ValueError(
                f"plan.deadline_s must be None or a positive number of "
                f"seconds, got {self.deadline_s!r}")
        if not isinstance(self.tuned, bool):
            raise ValueError(
                f"plan.tuned must be a bool, got {self.tuned!r}")
        if algebra is not None and self.warm == "always" \
                and algebra.kind != "monotone":
            raise ValueError(
                f"plan.warm='always' needs a monotone algebra; "
                f"{algebra.name} is {algebra.kind!r} (its fixpoint "
                "cannot resume from a prior result) -- use warm='auto' "
                "or 'never'")

    def resolve(self, algebra: VertexAlgebra | None = None,
                device: str | torch.device | None = None
                ) -> "ExecutionPlan":
        """Validate and collapse every 'auto' for `device` (default: the
        CUDA device; raises without one): relax_mode
        picks the route (the kernel needs a CUDA device, the plain
        version serves the CPU), compact follows the fabric mode, and
        feature_dim adopts the program's width. Resolving again is the
        identity."""
        self.validate(algebra)
        device = resolve_device(device, "ExecutionPlan.resolve")
        relax = resolve_relax_mode(self.relax_mode, device)
        if relax == "cuda" and device.type != "cuda":
            raise ValueError(
                "plan.relax_mode='cuda' needs a CUDA device, but the "
                f"session runs on {device}; use 'torch' or 'auto' on the "
                "CPU")
        if relax == "torch" and device.type == "cuda":
            raise ValueError(
                "plan.relax_mode='torch' on a CUDA device: the plain "
                "version serves the CPU only; use 'cuda' or 'auto'")
        compact = (self.mode == "data" if self.compact == "auto"
                   else bool(self.compact))
        d = self.feature_dim
        if d == 0:
            d = algebra.feature_dim if algebra is not None else 1
        plan = dataclasses.replace(self, relax_mode=relax, compact=compact,
                                   feature_dim=d)
        plan.validate(algebra)
        return plan


def plan_from_cli(engine: str, mode: str, compact: bool | str = "auto",
                  tile: int = 128, batch: int = 0,
                  feature_dim: int = 0) -> ExecutionPlan:
    """One ExecutionPlan from the graph_run CLI surface. `engine` keeps
    the reference's spelling: 'jax' is the local engine ('op' the
    deprecated spelling of 'jax' in op mode). The cycle simulator
    ('sim') takes no plan, and 'dist' (the distributed fixpoint) is not
    ported yet."""
    if engine == "op":
        engine, mode = "jax", "op"
    if engine == "dist":
        raise ValueError(
            "engine 'dist' is not ported yet: it waits for ROADMAP Queue 1 "
            "item 10 (distributed fixpoint); use --engine jax or sim")
    if engine != "jax":
        raise ValueError(
            f"engine {engine!r} takes no ExecutionPlan: the plan surface "
            "is the local engine's ('jax'); the cycle simulator ('sim') "
            "runs from a mapping alone")
    return ExecutionPlan(mode=mode, compact=compact, tile=tile,
                         batch=batch, feature_dim=feature_dim)
