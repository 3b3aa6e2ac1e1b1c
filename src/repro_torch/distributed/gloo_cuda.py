"""DTensor's collectives for gloo ranks that hold CUDA tensors.

DTensor redistributes through PyTorch's functional collectives
(`torch.ops._c10d_functional`, and `_dtensor.shard_dim_alltoall`). Over a
gloo process group with CUDA tensors, a DTensor redistribute from Shard
to Replicate (an all-gather) killed the process with SIGSEGV (PyTorch
2.11, two ranks on one H100), while the c10d API's all_reduce,
all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single on
the same tensors work (`chip_smoke.py` phase 20 probes them); gloo copies
CUDA tensors through the host either way. Ranks that share one card
cannot use NCCL, which refuses two ranks on one device, so such ranks run
on gloo.

`install()` registers, for the CUDA dispatch key, implementations of
those ops on the c10d API: synchronous, each result complete when the op
returns. `launch.mesh.make_mesh` calls it when the default process group's
backend is gloo and the mesh's device is CUDA -- chosen by the backend's
name, never by catching an error -- and it replaces the ops in that
process only: a process with NCCL groups never installs it. The compute
stays on the card.
"""
from __future__ import annotations

import sys
import threading
import warnings

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d

_LOCK = threading.Lock()
_LIB = None
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def _group(group_name):
    if isinstance(group_name, dist.ProcessGroup):
        return group_name
    return c10d._resolve_process_group(group_name)


def _reduce(t: torch.Tensor, reduce_op: str, pg) -> torch.Tensor:
    """All-reduce `t` in place; "avg" is a sum over the group's size
    (gloo has no AVG)."""
    op = reduce_op.lower()
    dist.all_reduce(t, op=_OPS["sum" if op == "avg" else op], group=pg)
    if op == "avg":
        t.div_(pg.size())
    return t


def all_reduce(input, reduce_op, group_name):
    return _reduce(input.clone(memory_format=torch.contiguous_format),
                   reduce_op, _group(group_name))


def all_reduce_(input, reduce_op, group_name):
    return _reduce(input, reduce_op, _group(group_name))


def all_gather_into_tensor(input, group_size, group_name):
    out = input.new_empty((group_size * input.shape[0], *input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(),
                                group=_group(group_name))
    return out


def reduce_scatter_tensor(input, reduce_op, group_size, group_name):
    pg = _group(group_name)
    full = _reduce(input.clone(memory_format=torch.contiguous_format),
                   reduce_op, pg)
    return full.chunk(group_size)[pg.rank()].clone()


def all_to_all_single(input, output_split_sizes, input_split_sizes,
                      group_name):
    out = input.new_empty((sum(output_split_sizes), *input.shape[1:]))
    dist.all_to_all_single(out, input.contiguous(),
                           list(output_split_sizes), list(input_split_sizes),
                           group=_group(group_name))
    return out


def shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
    """From shards along `gather_dim` to shards along `shard_dim`: the
    whole tensor gathered, this rank's chunk of it taken."""
    pg = _group(group_name)
    ws = pg.size()
    moved = input.movedim(gather_dim, 0).contiguous()
    full = moved.new_empty((ws * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(full, moved, group=pg)
    full = full.movedim(0, gather_dim)
    return full.chunk(ws, dim=shard_dim)[pg.rank()].contiguous()


def install(device_type: str = "cuda") -> bool:
    """Register the implementations above for `device_type`'s tensors
    (CUDA; the tests take the CPU), once per process. Returns whether
    this call installed them."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return False
        key = device_type.upper()
        lib = torch.library.Library("_c10d_functional", "IMPL")
        dt = torch.library.Library("_dtensor", "IMPL")
        with warnings.catch_warnings():
            # overriding the native CUDA kernels is the point
            warnings.simplefilter("ignore", UserWarning)
            for fn in (all_reduce, all_reduce_, all_gather_into_tensor,
                       reduce_scatter_tensor, all_to_all_single):
                lib.impl(fn.__name__, fn, key)
            dt.impl("shard_dim_alltoall", shard_dim_alltoall, key)
        _LIB = (lib, dt)
        print(f"[repro_torch] gloo with {key} tensors: DTensor's collectives "
              "go through the c10d API (distributed/gloo_cuda.py)",
              file=sys.stderr, flush=True)
        return True
