"""Device meshes: the port of `repro.launch.mesh`.

Each function builds a `torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group that is already up (`torchrun` starts one
process per rank; `init_process_group` joins them), with the reference's
axis names as `mesh_dim_names`. Defined as functions, so importing this
module touches no process group.

Mesh shapes:
  single-pod: (16, 16)    axes ("data", "model")
  multi-pod : (2, 16, 16) axes ("pod", "data", "model")
The "pod" axis is pure data parallelism (one gradient reduction per step
crosses it).

`device_type` is "cuda" unless the caller asks for "cpu" (gloo ranks on
the CPU): the port never falls back to the CPU on its own. A CUDA mesh
over a gloo group (ranks that share one card) routes DTensor's
collectives through the c10d API (`distributed.gloo_cuda`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import gloo_cuda


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device_type='cpu' for a mesh of CPU ranks")
    return "cuda"


def make_mesh(shape: tuple, axes: tuple, device_type: str | None = None
              ) -> DeviceMesh:
    """A mesh of `shape` named `axes` over every rank of the default
    process group, rank-major (the last axis varies fastest). Raises when
    no group is up or its size is not the product of `shape`."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh{shape}: no torch.distributed process group is up; "
            "start one process per rank with torchrun (e.g. `torchrun "
            "--nproc-per-node 2 ...`) and call init_process_group first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {shape} over {axes} needs {n} ranks; the "
                         f"process group has {world}")
    device_type = _device_type(device_type)
    if device_type == "cuda" and dist.get_backend() == "gloo":
        # ranks that share one card: DTensor's functional collectives
        # crash over gloo with CUDA tensors (distributed/gloo_cuda.py)
        gloo_cuda.install()
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def elastic_shape(n: int, preferred: tuple = (16, 16)) -> tuple[int, int]:
    """(data, model) for `n` ranks: keep the model axis as wide as the
    preferred one that divides `n` (halving it until it does) and give
    the data axis the rest -- on a restart after losing hosts the data
    axis shrinks and checkpoint resharding handles the rest."""
    model = preferred[-1]
    while model > 1 and n % model:
        model //= 2
    return n // model, model


def elastic_mesh(preferred: tuple = (16, 16), axes: tuple = ("data", "model"),
                 device_type: str | None = None) -> DeviceMesh:
    """The largest (data, model) mesh the live ranks support."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "elastic_mesh: no torch.distributed process group is up; start "
            "the ranks with torchrun and call init_process_group first")
    return make_mesh(elastic_shape(dist.get_world_size(), preferred), axes,
                     device_type)
