"""Logical-axis sharding over a `torch.distributed` device mesh.

The port of `repro.distributed.sharding`. Tensors are annotated with
*logical* axis names; a rules table maps them to the axes of a
`torch.distributed.device_mesh.DeviceMesh` whose `mesh_dim_names` are the
reference's (`pod`, `data`, `model`). `constrain` is the identity when no
mesh is set, so the same model code runs on one device and on a mesh of
ranks.

Default layout (the reference's DESIGN.md Sec. 5):
  batch        -> ("pod", "data")   activations: DP over pods + data rows
  seq          -> "model"           sequence parallelism between blocks
  kv_seq       -> "model"           decode KV caches
  long_kv_seq  -> ("data","model")  batch=1 long-context decode caches
  embed        -> "data"            weights: FSDP / ZeRO-3 shard
  heads/mlp/experts/vocab -> "model"  tensor/expert parallelism

`logical_to_pspec` returns the port's `PartitionSpec`, a tuple with one
entry per tensor dim (None, an axis name, or a tuple of axis names),
entry for entry the reference's. `placements` turns it into DTensor
placements: `Shard(i)` on each mesh dim that tensor dim i names,
`Replicate()` elsewhere. Under a mesh every activation is a DTensor and
`constrain` redistributes it, which is what the reference's
`with_sharding_constraint` asks of GSPMD; DTensor's sharding propagation
does the rest. An uneven dim that `_axis_ok` admits non-strictly becomes
an uneven DTensor shard (`torch.chunk`'s split) where GSPMD pads.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor.experimental import local_map


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def mesh_axes(self, logical: str | None):
        if logical is None:
            return None
        return self.rules.get(logical, None)


DEFAULT_RULES = ShardingRules(rules={
    # activations
    "batch": ("pod", "data"),
    "seq": "model",
    "kv_seq": "model",
    "long_kv_seq": ("data", "model"),
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    # weights
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    # MoE grouped dispatch (GShard flow): token groups span all token
    # shards before dispatch, and DP shards only after the (G,E) reshard
    "batch_seq_groups": ("pod", "data", "model"),
    "moe_groups": ("pod", "data"),
    "vocab": "model",
    "layers": None,
    "conv": None,
    "state": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
})


def activation_rules(**overrides) -> ShardingRules:
    r = dict(DEFAULT_RULES.rules)
    r.update(overrides)
    return ShardingRules(rules=r)


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    them (the counterpart of `jax.sharding.PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# --------------------------------------------------------------------- #
# ambient mesh + rules: the process's, not the thread's (the reference's
# are thread-local). Autograd runs the backward of CUDA tensors -- and
# with it a checkpointed block's recompute, which calls `constrain` -- on
# its own device threads, which must see the mesh of the thread that ran
# the forward. Nested contexts restore the outer one on exit.
# --------------------------------------------------------------------- #
class _Ctx:
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh, rules: ShardingRules | None = None):
    """Set the ambient mesh (a `DeviceMesh`, or None) and rules for the
    block, and restore the previous ones after it. A `DeviceMesh` has no
    `with` form of its own, so this is all the context does."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (the reference's `mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_ok(sizes: dict, dim: int, axes, strict: bool) -> bool:
    """Shardability check; tuples of mesh axes multiply.

    strict=True (parameters, caches) requires exact divisibility.
    strict=False (intermediates) also admits uneven dims down to 1/4
    occupancy (``4 * dim >= size``); smaller dims replicate either way."""
    if axes is None:
        return True
    size = 1
    for a in _axes(axes):
        size *= sizes[a]
    if dim % size == 0:
        return True
    return (not strict) and 4 * dim >= size


# parameter-sharding fallbacks: when a tensor dim cannot take its primary
# mesh axis (e.g. 40 heads on a 16-wide axis, strict mode), a secondary
# logical axis of the same tensor may claim it instead
FALLBACK_RULES = {"head_dim": "model", "expert_mlp": "model",
                  "ssm_head_dim": "model"}


def logical_to_pspec(shape, logical_axes, mesh=None,
                     rules: ShardingRules | None = None,
                     strict: bool = True) -> PartitionSpec:
    """PartitionSpec for a tensor given its logical axes (never fails:
    unshardable dims replicate). See `_axis_ok` for strict semantics."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return PartitionSpec()
    sizes = mesh_sizes(mesh)
    spec = []
    used: set = set()
    for dim, name in zip(shape, logical_axes):
        axes = rules.mesh_axes(name)
        if axes is not None:
            # drop mesh axes absent from this mesh (e.g. "pod" on a
            # single-pod mesh) or already used by another tensor dim
            flat = tuple(a for a in _axes(axes)
                         if a in sizes and a not in used)
            axes = flat if flat else None
            if axes is not None and len(axes) == 1:
                axes = axes[0]
        if axes is not None and not _axis_ok(sizes, dim, axes, strict):
            axes = None
        used.update(_axes(axes))
        spec.append(axes)
    # second pass: let fallback axes claim still-unused mesh axes (e.g.
    # shard wq over head_dim when the head count can't take "model")
    for i, (dim, name) in enumerate(zip(shape, logical_axes)):
        if spec[i] is not None:
            continue
        fb = FALLBACK_RULES.get(name)
        if fb and fb in sizes and fb not in used \
                and _axis_ok(sizes, dim, fb, strict):
            spec[i] = fb
            used.add(fb)
    return PartitionSpec(*spec)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: `Shard(i)` on each mesh
    dim that tensor dim i names, `Replicate()` on the others. A dim that
    names several mesh axes is split by them in mesh order, the first the
    major one, as GSPMD splits it."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"tensor dim {i} names mesh axes {axes} out of "
                             f"the mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a `PartitionSpec` (the counterpart of
    `jax.sharding.NamedSharding`)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named_sharding(shape, logical_axes, mesh=None,
                   rules: ShardingRules | None = None,
                   strict: bool = True) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("named_sharding requires a mesh")
    return NamedSharding(mesh, logical_to_pspec(shape, logical_axes, mesh,
                                                rules, strict))


def activation_placements(shape, *logical_axes) -> tuple:
    """Placements of an intermediate (non-strict) under the ambient
    mesh and rules."""
    mesh = _CTX.mesh
    return placements(logical_to_pspec(shape, logical_axes, mesh,
                                       _CTX.rules, strict=False), mesh)


def constrain(x, *logical_axes):
    """Redistribute `x` to its logical axes' placements (non-strict:
    intermediates may shard unevenly); the identity without a mesh.
    Under a mesh `x` must be a DTensor: every activation outside a
    `local_map` region is one, so a plain tensor here is a bug."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{logical_axes}: a plain {type(x).__name__} of shape "
            f"{tuple(x.shape)} under a device mesh; every activation under "
            "a mesh is a DTensor (shard the inputs with "
            "launch.steps.shard_batch)")
    want = activation_placements(x.shape, *logical_axes)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard_range(length: int, placements, mesh, dim: int) -> tuple[int, int]:
    """(offset, size) of this rank's slice of a tensor dim of `length`
    that `placements` split (`Shard(dim)` on one or more mesh dims, each
    `torch.chunk`'s split of the previous one's slice, in mesh order, as
    DTensor splits it); (0, length) where none does."""
    coord = mesh.get_coordinate()
    lo, size = 0, length
    for j, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            c = -(-size // mesh.shape[j])
            start = min(coord[j] * c, size)
            lo, size = lo + start, max(0, min(c, size - start))
    return lo, size


def replicated_like(x, t: torch.Tensor):
    """`t` (a plain tensor every rank holds alike) as a replicated
    DTensor on `x`'s mesh when `x` is a DTensor; `t` itself otherwise."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_region(fn, out_placements, in_placements: tuple, mesh,
                 shapes=None):
    """`local_map(fn)` over `mesh` that redistributes its inputs to
    `in_placements` (None for an argument that is no DTensor). The
    gradient of an input that is replicated on a mesh dim where another
    input is sharded comes back `Partial` there: each rank's local
    gradient is its share of the work, summed over that dim. `shapes`
    (one global shape, or one per output) gives outputs whose split may
    be uneven their true global shape (`_global_shape`)."""
    split = [any(pl is not None and isinstance(pl[j], Shard)
                 for pl in in_placements) for j in range(mesh.ndim)]
    grad = tuple(
        None if pl is None else tuple(
            Partial() if isinstance(p, Replicate) and split[j] else p
            for j, p in enumerate(pl))
        for pl in in_placements)
    if all(isinstance(p, Placement) for p in out_placements):
        out = list(out_placements)          # one output
    else:
        out = tuple(list(p) for p in out_placements)
    run = local_map(fn, out_placements=out,
                    in_placements=in_placements, in_grad_placements=grad,
                    device_mesh=mesh, redistribute_inputs=True)
    if shapes is None:
        return run

    def uneven(*args):
        res = run(*args)
        one = isinstance(res, DTensor)
        outs, shp = ((res,), (shapes,)) if one else (res, shapes)
        outs = tuple(_global_shape(o, s) for o, s in zip(outs, shp))
        return outs[0] if one else outs
    return uneven


def _global_shape(x: DTensor, shape) -> DTensor:
    """`x` with its global shape `shape`: `local_map` infers a global shape
    from this rank's local one as if every split were even, which an
    uneven split (torch.chunk's, where a dim does not divide) is not."""
    if shape is None or tuple(x.shape) == tuple(shape):
        return x
    shape = torch.Size(shape)
    stride, n = [], 1
    for d in reversed(shape):           # contiguous; no tensor is made
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=tuple(stride))
