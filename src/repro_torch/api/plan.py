"""ExecutionPlan: every execution knob of a query in one typed, validated
place.

The port of `repro.api.plan`. The fields keep the reference's names and
meanings; `relax_mode` names the port's routes ('auto' | 'cuda' |
'torch'). `resolve(algebra, device)` validates every combination up
front and collapses every ``"auto"``, so a resolved plan is a complete
record of how a query ran. The reference's `mesh` (a jax Mesh) is a
`torch.distributed` `DeviceMesh` here, whose `mesh_axis` dim's process
group the distributed fixpoint runs over, or a process group itself.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
from torch.distributed.device_mesh import DeviceMesh

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
    distributed -- run the distributed fixpoint: destination tiles split
                   over the ranks of `mesh`, queries replicated, one
                   all-gather per step.
    mesh        -- a `DeviceMesh` (the tiles shard over its
                   `mesh_axis`), or the `torch.distributed` process group
                   of a distributed run (None = the default group when
                   one is initialised, else one rank with no
                   collective); supplying either implies
                   distributed=True.
    mesh_axis   -- the mesh axis the tiles shard over (a `DeviceMesh`
                   mesh only).
    warm        -- incremental-recompute policy for `query(..., warm=)`:
                   'auto' resumes from the prior result whenever sound
                   (monotone algebra + monotone update delta) and
                   recomputes from scratch otherwise; 'always' raises
                   instead of recomputing; 'never' forbids warm starts.
    feature_dim -- feature width d: 0 adopts the program's native width;
                   vector programs only run at their native width.
    max_steps   -- fixpoint safety valve.
    deadline_s  -- default per-request wall-clock budget in seconds
                   (None = unbounded), enforced at step boundaries. Not
                   supported on distributed plans.
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
    distributed: bool = False
    mesh: object = None          # DeviceMesh | ProcessGroup | None
    mesh_axis: str = "data"
    warm: str = "auto"
    feature_dim: int = 0
    max_steps: int = 100_000
    deadline_s: float | None = None
    tuned: bool = False

    def key(self) -> tuple:
        """Hashable cache key (session caches key on fingerprint+plan).
        The process group participates by identity: two plans over
        different groups never share a session."""
        return (self.mode, self.relax_mode, self.compact, self.tile,
                self.batch, self.distributed,
                None if self.mesh is None else id(self.mesh),
                self.mesh_axis, self.warm,
                self.feature_dim, self.max_steps, self.deadline_s,
                self.tuned)

    def group(self):
        """The process group of a distributed run: `mesh[mesh_axis]`'s
        for a `DeviceMesh`, else `mesh` itself (a group, or None)."""
        if isinstance(self.mesh, DeviceMesh):
            return self.mesh[self.mesh_axis].get_group()
        return self.mesh

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
        if isinstance(self.mesh, DeviceMesh) \
                and self.mesh_axis not in self.mesh.mesh_dim_names:
            raise ValueError(
                f"plan.mesh_axis={self.mesh_axis!r} is not an axis of the "
                f"mesh {self.mesh.mesh_dim_names}")
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
        if self.deadline_s is not None and (
                self.distributed or self.mesh is not None):
            raise ValueError(
                "plan.deadline_s is not supported on distributed plans: "
                "the distributed fixpoint enforces no deadline at its "
                "step boundaries -- use max_steps")
        if not isinstance(self.tuned, bool):
            raise ValueError(
                f"plan.tuned must be a bool, got {self.tuned!r}")
        if self.tuned and (self.distributed or self.mesh is not None):
            raise ValueError(
                "plan.tuned is not supported on distributed plans: the "
                "tuning sweep measures local run_segment segments, "
                "which say nothing about the distributed dispatch -- "
                "tune a local plan, then add the process group")
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
        version serves the CPU), compact follows the fabric mode,
        feature_dim adopts the program's width, and a supplied process
        group implies distributed execution. Resolving again is the
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
        plan = dataclasses.replace(
            self, relax_mode=relax, compact=compact, feature_dim=d,
            distributed=bool(self.distributed or self.mesh is not None))
        plan.validate(algebra)
        return plan


def resolve_cli_engine(engine: str, mode: str) -> tuple[str, str]:
    """Collapse deprecated CLI spellings so every option has one canonical
    form, as the reference does. ``--engine op`` is the pre-split spelling
    of ``--engine jax --mode op``: still accepted, it warns once with a
    `DeprecationWarning` (the default filter deduplicates repeats)."""
    if engine == "op":
        warnings.warn(
            "--engine op is deprecated; use --engine jax --mode op",
            DeprecationWarning, stacklevel=2)
        return "jax", "op"
    return engine, mode


def plan_from_cli(engine: str, mode: str, compact: bool | str = "auto",
                  tile: int = 128, batch: int = 0,
                  feature_dim: int = 0) -> ExecutionPlan:
    """One ExecutionPlan from the graph_run CLI surface. `engine` keeps
    the reference's spelling: 'jax' is the local engine ('op' the
    deprecated spelling of 'jax' in op mode, folded by
    `resolve_cli_engine`) and 'dist' the distributed fixpoint over the
    default process group. The cycle simulator ('sim') takes no plan."""
    engine, mode = resolve_cli_engine(engine, mode)
    if engine not in ("jax", "dist"):
        raise ValueError(
            f"engine {engine!r} takes no ExecutionPlan: the plan surface "
            "is the engines' ('jax', 'dist'); the cycle simulator ('sim') "
            "runs from a mapping alone")
    return ExecutionPlan(mode=mode, compact=compact, tile=tile,
                         batch=batch, distributed=(engine == "dist"),
                         feature_dim=feature_dim)
