"""Multi-pod dry-run on the H100 port: run every (arch x shape x mesh)
cell's step on fake tensors over a fake 256- or 512-rank mesh.

The port of `repro.launch.dryrun`. For each cell it:
  * builds the production mesh ((16,16) single-pod / (2,16,16) multi-pod,
    `launch.mesh.make_production_mesh`) over a fake process group of that
    many ranks in this one process (`torch.testing`'s `FakeStore`; this
    process is rank 0, and its coordinate decides which shard it holds);
  * under `FakeTensorMode` builds the parameters, AdamW state, batch or
    caches as DTensors of this rank's shards in their `launch.steps`
    shardings -- nothing is allocated, no device is touched -- and runs
    the cell's whole step on them: train (forward, backward and AdamW),
    prefill or decode. A sharding that does not propagate fails here (the
    counterpart of the reference's `lower().compile()`);
  * counts, per device, with one dispatch mode (`Counter`) over the local
    ops: FLOPs by `torch.utils.flop_counter`'s formulas (K2 and K3 by
    theirs, `kernels.cost`, through their custom ops' fake
    implementations), bytes accessed (each non-view op's inputs read once
    and outputs written once), and the collectives DTensor issues
    (`collective_bytes`: max(operand, output) bytes per op, by kind, the
    reference's rule), their counts held against DTensor's
    `CommDebugMode`; memory: `arg_bytes` exactly (the local shards of the
    state and inputs), the peak from `MemTracker`;
  * as the reference does, takes the roofline terms from components: one
    pattern period (`models.model.apply_superblock` with its gradient for
    train, forward for prefill, `superblock_decode` for decode) and the
    head, ``total = layer x repeat + head`` (`measure_components`);
  * writes `<out>/<arch>__<shape>__<single|multi>[__tag].json` with the
    reference's keys.

DTensor derives each op's output metadata by running it on fake tensors
of the global shapes; the counters must not see that, so the sharding
propagator runs with the dispatch modes off (`_quiet_propagation`).

The hardware constants are the H100 SXM's (`PERF.md` section 3's device
row), not TPU v5e's. The collective term uses one constant as the
reference does: a 16-wide model axis spans two 8-GPU nodes, so it is one
400 Gb/s InfiniBand NIC per GPU, 50e9 B/s.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k \\
      [--multi-pod] [--moe-dispatch gspmd|all_to_all] [--out DIR]
  python -m repro_torch.launch.dryrun --all [--multi-pod]

Unlike the reference's CLI, which prints [FAIL] for a failed cell and
exits 0, this one exits 1 when any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.layers import DTYPES
from repro_torch.optim.adamw import AdamWConfig

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
# the ops DTensor (`_c10d_functional`, `_dtensor`) and `torch.distributed`
# (`c10d`) issue, by the reference's kinds
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
# (a collective outside this table fails `collective_bytes`' hold)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

# H100 SXM (PERF.md section 3): dense bf16 tensor-core rate, HBM3 rate
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# one 400 Gb/s InfiniBand NIC per GPU: a 16-wide model axis spans two
# 8-GPU nodes, so its collectives leave the node's NVLink domain
NET_BW = 50e9


# the fake tensors' device and the mesh's: the CPU, so that no step of
# the dry-run needs a card (autograd's CUDA device threads would); DTensor's
# one CPU-only path, the all-to-all, is shown as on the card
# (`_card_collectives`)
DEVICE = "cpu"


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class Counter(TorchDispatchMode):
    """Per-device counts of the ops it sees: DTensor ops pass through
    (NotImplemented) to DTensor, whose local ops on this rank's shards it
    then sees. Ops without a FLOP formula are decomposed first, as
    `FlopCounterMode` does, so both count the same on plain tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVE_OPS}
        self.counts = {k: 0 for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _KINDS.get(packet.__name__) \
            if func.namespace in _COLLECTIVE_NAMESPACES else None
        if kind is not None:
            ins = _tensors((args, kwargs))
            # an in-place c10d op takes its output buffer as an argument
            operand = (max(map(_nbytes, ins)) if func.namespace == "c10d"
                       else sum(map(_nbytes, ins)))
            self.coll[kind] += max(operand, sum(map(_nbytes,
                                                    _tensors(out))))
            self.counts[kind] += 1
        elif not func.is_view and packet is not \
                torch.ops._c10d_functional.wait_tensor:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs, out))))
        return out

    def result(self) -> dict:
        coll = dict(self.coll, counts=dict(self.counts))
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(sum(self.coll.values())), "collectives": coll}


def collective_bytes(counter: Counter, comm_counts: dict) -> dict:
    """The counter's bytes by kind, with counts, after holding its counts
    against DTensor's `CommDebugMode` (`comm_counts`: its
    `get_comm_counts()`, by op): a collective that one of them missed
    raises."""
    want = {k: 0 for k in COLLECTIVE_OPS}
    for op, n in comm_counts.items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        kind = _KINDS.get(name)
        if kind is None:
            raise RuntimeError(f"dryrun: CommDebugMode counted {op}, which "
                               "the counter does not know")
        want[kind] += n
    if want != counter.counts:
        raise RuntimeError(f"dryrun: collective counts {counter.counts} "
                           f"differ from CommDebugMode's {want}")
    return counter.result()["collectives"]


@contextlib.contextmanager
def _quiet_propagation():
    """Run DTensor's sharding propagator with every dispatch mode off: it
    runs each new op on fake tensors of the global shapes to derive the
    output's metadata, which is no work of this rank's."""
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in ("propagate", "propagate_op_sharding",
                         "propagate_op_sharding_non_cached",
                         "_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if callable(getattr(prop, n, None))]
    if not names:
        raise RuntimeError("dryrun: DTensor's sharding propagator has none "
                           "of the methods it wraps; the counts would "
                           "include its global-shape metadata ops")
    saved = {n: prop.__dict__.get(n) for n in names}

    def quiet(fn):
        def run(*a, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        return run
    for n in names:
        setattr(prop, n, quiet(getattr(prop, n)))
    try:
        yield
    finally:
        for n, f in saved.items():
            if f is None:
                delattr(prop, n)
            else:
                setattr(prop, n, f)


@contextlib.contextmanager
def _card_collectives():
    """DTensor's shard-to-shard redistribution as on the card: over a CPU
    mesh it falls back to an all-gather and a chunk (gloo has no
    all-to-all); the fake mesh stands for CUDA ranks, whose NCCL takes the
    all-to-all (`_dtensor::shard_dim_alltoall`), so the mesh shows itself
    as CUDA to that one function while it runs."""
    import importlib
    mods = [importlib.import_module(f"torch.distributed.tensor.{m}")
            for m in ("placement_types", "_collective_utils")]
    mods = [m for m in mods if callable(getattr(m, "shard_dim_alltoall",
                                                None))]
    saved = {m: m.shard_dim_alltoall for m in mods}

    def as_cuda(fn):
        def run(input, gather_dim, shard_dim, mesh, mesh_dim):
            attr = ("_device_type" if isinstance(
                type(mesh).__dict__.get("device_type"), property)
                else "device_type")
            was = getattr(mesh, attr)
            setattr(mesh, attr, "cuda")
            try:
                return fn(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                setattr(mesh, attr, was)
        return run
    for m, f in saved.items():
        m.shard_dim_alltoall = as_cuda(f)
    try:
        yield
    finally:
        for m, f in saved.items():
            m.shard_dim_alltoall = f


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of `world` ranks in this process (rank 0), for
    the block. Raises when a process group is up already (a real one
    cannot share the process with it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            f"dryrun: a process group of {dist.get_world_size()} ranks is "
            f"up; the dry-run makes a fake one of {world} in a process of "
            "its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# fake shards
# --------------------------------------------------------------------- #
def _local_shape(shape, placements, mesh) -> tuple:
    out = list(shape)
    for dim in range(len(shape)):
        out[dim] = sh.shard_range(shape[dim], placements, mesh, dim)[1]
    return tuple(out)


def fake_shard(t: torch.Tensor, sharding: sh.NamedSharding | None):
    """A DTensor of `t`'s global shape and dtype in `sharding`'s
    placements, its local tensor this rank's shard, made in the ambient
    (fake) tensor mode; without a sharding, a plain tensor of `t`'s shape
    and dtype."""
    if sharding is None:
        return torch.empty(t.shape, dtype=t.dtype, device=DEVICE)
    mesh, pl = sharding.mesh, sharding.placements
    local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                        device=DEVICE)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _shard_module(mod: nn.Module, shardings: dict | None) -> None:
    """Each parameter of `mod` (meta) replaced by its fake shard (a plain
    fake tensor without shardings)."""
    for prefix, m in mod.named_modules():
        for name, p in list(m.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            m._parameters[name] = nn.Parameter(
                fake_shard(p.detach(), shardings and shardings[full]),
                requires_grad=False)


def local_bytes(tensors) -> int:
    """The bytes of this rank's shards of `tensors` (DTensors or plain)."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tensors)


def _opt_cfg(cfg) -> AdamWConfig:
    return AdamWConfig(moment_dtype=("bfloat16" if cfg.param_count() > 50e9
                                     else "float32"))


def _sharding(mesh, shape, axes, rules):
    if mesh is None:
        return None
    return sh.NamedSharding(mesh, sh.logical_to_pspec(shape, axes, mesh,
                                                      rules))


def _cache_shards(cfg, mesh, batch: int, seq: int, rules, long_ctx: bool,
                  layers=None) -> list:
    abstract = M.abstract_cache(cfg, batch, seq, long_ctx=long_ctx)
    axes = M.cache_logical_axes(cfg, long_ctx=long_ctx)
    if layers is not None:
        abstract, axes = abstract[:layers], axes[:layers]
    return [{k: fake_shard(a, _sharding(mesh, a.shape, ax[k], rules))
             for k, a in layer.items()} for layer, ax in zip(abstract, axes)]


def _input(shape, dtype, axes, mesh, rules):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return fake_shard(t, _sharding(mesh, shape, axes, rules))


def _batch(cfg, b: int, seq: int, step_kind: str, mesh, rules) -> dict:
    ins = S.input_specs(cfg, seq, b, step_kind)["batch"]
    return {k: fake_shard(v, _sharding(mesh, v.shape, S.BATCH_AXES[k],
                                       rules))
            for k, v in ins.items()}


def _measured(fn, track=None):
    """fn() under a `Counter` and `CommDebugMode` (DTensor's propagation
    quiet, its all-to-all as on the card) and, when `track` lists the
    arguments' tensors, `MemTracker` in the same pass. Returns (fn's
    result, the counts, the peak bytes or None, why there is none)."""
    from torch.distributed.tensor.debug import CommDebugMode
    counter = Counter()
    peak, why, mt = None, "", contextlib.nullcontext()
    if track is not None:
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
            mt = MemTracker()
            mt.track_external(*track)
        except ImportError as e:
            why = f"MemTracker unavailable: {e}"
    with _quiet_propagation(), _card_collectives(), \
            CommDebugMode() as comm, mt, counter:
        out = fn()
    coll = collective_bytes(counter, comm.get_comm_counts())
    if track is not None and not why:
        snap = mt.get_tracker_snapshot("peak")
        peak = int(sum(v.get("Total", 0) for v in snap.values()))
    return out, dict(counter.result(), collectives=coll), peak, why


# --------------------------------------------------------------------- #
# components
# --------------------------------------------------------------------- #
def measure_components(cfg, shape: str, mesh, rules, moe_dispatch: str,
                       params=None) -> dict:
    """Roofline terms from one pattern period and the head, ``total =
    layer x repeat + head``, as the reference assembles them (its XLA
    cost model counts a scan body once; here the split keeps the same
    accounting). Train: the period's forward and gradient (per-block
    remat) and the gradient of embed + final norm + chunked CE; prefill:
    the period's forward and the last position's logits; decode: one
    `superblock_decode` over the period's caches and the token's logits.
    `params`: the cell's sharded fake `LM`, else built here. Call under
    `FakeTensorMode` and the ambient mesh."""
    spec = C.SHAPES[shape]
    b, s_len, kind = spec["global_batch"], spec["seq_len"], spec["step"]
    long_ctx = shape == "long_500k"
    act = DTYPES[cfg.activation_dtype]
    blocks = M.superblock(cfg, "meta")
    _shard_module(blocks, {n: _sharding(mesh, d.shape, d.logical_axes, rules)
                           for n, d in M.superblock_decls(cfg).items()})
    if params is None:
        params = _fake_params(cfg, mesh, rules)
    x = _input((b, 1 if kind == "decode" else s_len, cfg.d_model), act,
               ("batch", "seq", None), mesh, rules)

    if kind in ("train", "prefill"):
        def layer_fn():
            if kind == "prefill":
                with torch.no_grad():
                    return M.apply_superblock(blocks, x, cfg, moe_dispatch,
                                              remat=False)
            leaves = list(blocks.parameters())
            blocks.requires_grad_(True)
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                out, aux = M.apply_superblock(blocks, xg, cfg, moe_dispatch,
                                              remat=True)
                loss = out.float().sum() + aux
                grads = torch.autograd.grad(loss, leaves + [xg],
                                            allow_unused=True)
            blocks.requires_grad_(False)
            # the gradients in the parameters' and x's placements, as the
            # train step keeps them
            return [g if g is None or tuple(g.placements) == tuple(
                p.placements) else g.redistribute(p.device_mesh,
                                                  p.placements)
                    for g, p in zip(grads, leaves + [x])]
        _, layer, _, _ = _measured(layer_fn)

        batch = _batch(cfg, b, s_len, kind, mesh, rules)

        def head_fn():
            if kind == "prefill":
                with torch.no_grad():
                    h = M.embed_inputs(params, batch, cfg)
                    return (h[:, -1:] @ params.head_weights().T).float()
            head = [params.embedding[n] for n in params.embedding.decls] \
                + [params.final["final_norm"]]
            params.requires_grad_(True)
            with torch.enable_grad():
                h = M.embed_inputs(params, batch, cfg).to(act)
                loss = M.head_loss(params, h, batch["labels"], cfg,
                                   scan_chunks=False)
                if isinstance(loss, DTensor):
                    loss = loss.full_tensor()
                grads = torch.autograd.grad(loss, head, allow_unused=True)
            params.requires_grad_(False)
            return grads
        _, head, _, _ = _measured(head_fn)
    else:
        caches = _cache_shards(cfg, mesh, b, s_len, rules, long_ctx,
                               layers=len(cfg.pattern))
        pos = _input((b,), torch.int32, ("batch",), mesh, rules)
        tokens = _input((b, 1), torch.int32, ("batch", None), mesh, rules)

        @torch.no_grad()
        def layer_fn():
            return M.superblock_decode(blocks, caches, x, pos, cfg,
                                       long_ctx=long_ctx,
                                       moe_dispatch=moe_dispatch)
        _, layer, _, _ = _measured(layer_fn)

        @torch.no_grad()
        def head_fn():
            h = sh.constrain(M.embed_tokens(params, tokens, cfg), "batch",
                             None, None)
            return (h @ params.head_weights().T).float()
        _, head, _, _ = _measured(head_fn)

    rep = cfg.repeat
    return {
        "layer": layer, "head": head, "repeat": rep,
        "flops": layer["flops"] * rep + head["flops"],
        "bytes": layer["bytes"] * rep + head["bytes"],
        "coll": layer["coll"] * rep + head["coll"],
    }


# --------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------- #
def _fake_params(cfg, mesh, rules):
    params = M.abstract_params(cfg)
    _shard_module(params, None if mesh is None
                  else S.param_shardings(cfg, mesh, rules))
    return params


def _whole_step(cfg, kind: str, b: int, seq: int, mesh, rules,
                moe_dispatch: str, long_ctx: bool = False, opt_cfg=None):
    """A step's fake state and inputs (this rank's shards under a mesh,
    whole tensors without one), and a thunk that runs the whole step on
    them. Returns (thunk, the state's tensors, the inputs' tensors,
    params)."""
    params = _fake_params(cfg, mesh, rules)
    if kind == "train":
        opt_cfg = opt_cfg or _opt_cfg(cfg)
        mdt = DTYPES[opt_cfg.moment_dtype]
        psh = (S.param_shardings(cfg, mesh, rules) if mesh is not None
               else {})
        opt = {m: {n: fake_shard(torch.empty(p.shape, dtype=mdt,
                                             device="meta"), psh.get(n))
                   for n, p in params.named_parameters()}
               for m in ("mu", "nu")}
        opt["step"] = _input((), torch.int32, (), mesh, rules)
        state = {"params": params, "opt": opt}
        batch = _batch(cfg, b, seq, kind, mesh, rules)
        # `device` is only checked: the step runs on the fake tensors
        step = S.make_train_step(cfg, opt_cfg, moe_dispatch=moe_dispatch,
                                 device="cpu")
        held = (list(params.parameters()) + list(opt["mu"].values())
                + list(opt["nu"].values()) + [opt["step"]])
        return ((lambda: step(state, batch)), held, list(batch.values()),
                params)
    if kind == "prefill":
        batch = _batch(cfg, b, seq, kind, mesh, rules)
        step = S.make_prefill_step(cfg, moe_dispatch=moe_dispatch)
        return ((lambda: step(params, batch)), list(params.parameters()),
                list(batch.values()), params)
    caches = _cache_shards(cfg, mesh, b, seq, rules, long_ctx)
    tokens = _input((b, 1), torch.int32, ("batch", None), mesh, rules)
    pos = _input((b,), torch.int32, ("batch",), mesh, rules)
    step = S.make_decode_step(cfg, long_ctx=long_ctx,
                              moe_dispatch=moe_dispatch)
    return ((lambda: step(params, caches, tokens, pos)),
            list(params.parameters()),
            [t for layer in caches for t in layer.values()] + [tokens, pos],
            params)


def _measure_step(cfg, kind: str, b: int, seq: int, mesh, rules,
                  moe_dispatch: str, long_ctx: bool = False,
                  opt_cfg=None) -> dict:
    """The whole step's counts, argument bytes and peak (under the
    ambient fake tensor mode and mesh)."""
    t0 = time.time()
    step, state, inputs, _ = _whole_step(cfg, kind, b, seq, mesh, rules,
                                         moe_dispatch, long_ctx, opt_cfg)
    t_build = time.time() - t0
    t0 = time.time()
    out, counts, peak, why = _measured(step, track=state + inputs)
    held = {id(t) for t in state + inputs}      # updated in place
    out_bytes = local_bytes(t for t in _tensors(out) if id(t) not in held)
    del out
    t_run = time.time() - t0
    return dict(counts, state_bytes=local_bytes(state),
                input_bytes=local_bytes(inputs),
                arg_bytes=local_bytes(state) + local_bytes(inputs),
                out_bytes=out_bytes, peak_bytes=peak, peak_note=why,
                build_s=t_build, run_s=t_run)


def measure_step(cfg, kind: str, batch: int, seq: int,
                 mesh_shape: tuple | None = None, moe_dispatch="gspmd",
                 long_ctx: bool = False, opt_cfg=None,
                 rules=sh.DEFAULT_RULES) -> dict:
    """One step of `cfg` (train with `opt_cfg`, default AdamW's f32
    moments; prefill; decode against a `seq`-deep cache) at global batch
    `batch` on fake tensors: without a mesh, or on a fake mesh of
    `mesh_shape` ((data, model) or (pod, data, model)) over a fake
    process group of its size. Returns per-device "flops", "bytes",
    "coll", "collectives", "state_bytes" (parameters and optimizer
    state), "input_bytes", "arg_bytes", "out_bytes", "peak_bytes" (None
    with "peak_note" when MemTracker does not run). What `chip_smoke.py`
    holds the card's count against."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh_shape is None:
        with FakeTensorMode(), sh.mesh_context(None, rules):
            return _measure_step(cfg, kind, batch, seq, None, rules,
                                 moe_dispatch, long_ctx, opt_cfg)
    world = 1
    for n in mesh_shape:
        world *= n
    with fake_world(world):
        mesh = _mesh_of(False, mesh_shape)
        with FakeTensorMode(), sh.mesh_context(mesh, rules):
            return _measure_step(cfg, kind, batch, seq, mesh, rules,
                                 moe_dispatch, long_ctx, opt_cfg)


class _Rank0Mesh:
    """A mesh's names and sizes, seen from rank 0 (the fake process
    group's rank), for shard arithmetic without a process group."""

    def __init__(self, shape: tuple, axes: tuple):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)
        self.ndim = len(shape)

    def get_coordinate(self) -> tuple:
        return (0,) * self.ndim


def _shard_bytes(shape, dtype, axes, mesh, rules) -> int:
    local = _local_shape(shape, sh.placements(sh.logical_to_pspec(
        shape, axes, mesh, rules), mesh), mesh)
    n = 1
    for d in local:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def cell_arg_bytes(arch: str, shape: str, multi_pod: bool = False,
                   rules=sh.DEFAULT_RULES, cfg=None,
                   mesh_shape: tuple | None = None) -> dict:
    """Rank 0's bytes of a cell's state (parameters and, for train, AdamW's
    moments and step) and inputs (batch; or caches, tokens and
    positions) on its mesh, from shapes alone: the shards `_whole_step`
    builds (`run_cell`'s "arg_bytes" is their sum)."""
    cfg = cfg or C.get(arch)
    spec = C.SHAPES[shape]
    b, seq, kind = spec["global_batch"], spec["seq_len"], spec["step"]
    shape_of = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    mesh = _Rank0Mesh(shape_of, ("data", "model") if len(shape_of) == 2
                      else ("pod", "data", "model"))
    pdt = DTYPES[cfg.param_dtype]
    decls = S.param_decls(cfg)
    state = sum(_shard_bytes(d.shape, pdt, d.logical_axes, mesh, rules)
                for d in decls.values())
    if kind == "train":
        mdt = DTYPES[_opt_cfg(cfg).moment_dtype]
        state += 2 * sum(_shard_bytes(d.shape, mdt, d.logical_axes, mesh,
                                      rules) for d in decls.values())
        state += _shard_bytes((), torch.int32, (), mesh, rules)
        ins = S.input_specs(cfg, seq, b, kind)["batch"]
        inputs = sum(_shard_bytes(v.shape, v.dtype, S.BATCH_AXES[k], mesh,
                                  rules) for k, v in ins.items())
    elif kind == "prefill":
        ins = S.input_specs(cfg, seq, b, kind)["batch"]
        inputs = sum(_shard_bytes(v.shape, v.dtype, S.BATCH_AXES[k], mesh,
                                  rules) for k, v in ins.items())
    else:
        long_ctx = shape == "long_500k"
        cache = M.abstract_cache(cfg, b, seq, long_ctx=long_ctx)
        axes = M.cache_logical_axes(cfg, long_ctx=long_ctx)
        inputs = sum(_shard_bytes(a.shape, a.dtype, ax[k], mesh, rules)
                     for layer, ax in zip(cache, axes)
                     for k, a in layer.items())
        inputs += _shard_bytes((b, 1), torch.int32, ("batch", None), mesh,
                               rules)
        inputs += _shard_bytes((b,), torch.int32, ("batch",), mesh, rules)
    return {"state_bytes": state, "input_bytes": inputs}


def cell_name(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    name = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    return name + (f"__{tag}" if tag else "")


def _mesh_of(multi_pod: bool, mesh_shape: tuple | None):
    """The cell's mesh over the live (fake) process group: the
    production mesh, or `mesh_shape` over (data, model) or (pod, data,
    model)."""
    if mesh_shape is None:
        return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type=DEVICE)
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    return mesh_lib.make_mesh(mesh_shape, axes, device_type=DEVICE)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             moe_dispatch: str = "gspmd", rules=sh.DEFAULT_RULES,
             save_dir: str | None = "experiments/dryrun_torch",
             components: bool = True, tag: str = "", cfg=None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell on its production mesh over a fake process group (made
    here when none is up). Returns the reference's result dict (or
    {"arch", "shape", "skipped": reason}); writes it to `save_dir`.
    `cfg` (default: the arch's config) and `mesh_shape` (default: the
    production mesh) cut a cell to a test's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or C.get(arch)
    spec = C.SHAPES[shape]
    ok, reason = C.shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "skipped": reason}
    shape_of = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    world = 1
    for n in shape_of:
        world *= n
    step_kind = spec["step"]
    long_ctx = shape == "long_500k"
    with fake_world(world):
        mesh = _mesh_of(multi_pod, mesh_shape)
        with FakeTensorMode(), sh.mesh_context(mesh, rules):
            whole = _measure_step(cfg, step_kind, spec["global_batch"],
                                  spec["seq_len"], mesh, rules, moe_dispatch,
                                  long_ctx, _opt_cfg(cfg))
            if components:
                comp = measure_components(cfg, shape, mesh, rules,
                                          moe_dispatch)
            else:
                z = {"flops": 0.0, "bytes": 0.0, "coll": 0.0,
                     "collectives": {}}
                comp = {"layer": z, "head": z, "repeat": cfg.repeat,
                        "flops": whole["flops"], "bytes": whole["bytes"],
                        "coll": whole["coll"]}
    chips = world
    peak, arg_bytes = whole["peak_bytes"], whole["arg_bytes"]
    # the counterparts of the reference's lower() and compile(): building
    # the sharded fake state, and the whole step's run on it
    t_lower, t_compile = whole["build_s"], whole["run_s"]

    flops, bytes_acc, coll_total = comp["flops"], comp["bytes"], comp["coll"]
    n_active = cfg.param_count(active_only=True)
    tokens = spec["global_batch"] * (spec["seq_len"]
                                     if step_kind in ("train", "prefill")
                                     else 1)
    model_flops = (6 if step_kind == "train" else 2) * n_active * tokens
    temp = None if peak is None else max(0, peak - arg_bytes)
    result = {
        "arch": arch, "shape": shape,
        "mesh": ("multi" if multi_pod else "single")
        + "(" + ",".join(map(str, shape_of)) + ")",
        "chips": chips, "step": step_kind,
        "moe_dispatch": moe_dispatch,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            # the peak holds the arguments, the temporaries and the
            # outputs alive at that moment
            "bytes_per_device": peak,
            "temp_bytes": temp,
            "arg_bytes": int(arg_bytes),
            "out_bytes": int(whole["out_bytes"]),
            "peak_bytes": peak,
            "note": whole["peak_note"] or (
                "arg_bytes: this rank's shards of the state and inputs; "
                "peak_bytes: MemTracker under FakeTensorMode; temp_bytes "
                "= peak - args"),
        },
        "hlo_flops": flops,
        "hlo_bytes": bytes_acc,
        "collective_bytes": coll_total,
        "components": {
            "layer": comp["layer"], "head": comp["head"],
            "repeat": comp["repeat"],
        },
        "whole_program": dict(
            {k: whole[k] for k in ("flops", "bytes", "collectives")}, note=(
            "the whole step on fake tensors: every layer counted, the "
            "optimizer and the embedding too")),
        "model_flops": model_flops,
        "roofline": {
            # per device: every count is of this rank's local ops
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll_total / NET_BW,
        },
    }
    r = result["roofline"]
    result["roofline"]["dominant"] = max(r, key=r.get)
    result["useful_flops_frac"] = (model_flops / (flops * chips)) \
        if flops else 0.0
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, cell_name(arch, shape, multi_pod, tag)
                            + ".json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-dispatch", default="gspmd",
                    choices=("gspmd", "all_to_all"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-components", action="store_true",
                    help="skip the per-component measurement (multi-pod "
                         "validation pass)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        run, skipped = C.cells()
        cells = sorted(run + [(a, s) for a, s, _ in skipped],
                       key=lambda c: (C.ARCH_IDS.index(c[0]),
                                      list(C.SHAPES).index(c[1])))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failed = 0
    for arch, shape in cells:
        name = cell_name(arch, shape, args.multi_pod, args.tag)
        path = os.path.join(args.out, name + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {name}", flush=True)
            continue
        try:
            r = run_cell(arch, shape, multi_pod=args.multi_pod,
                         moe_dispatch=args.moe_dispatch,
                         save_dir=args.out, tag=args.tag,
                         components=not args.no_components)
            if "skipped" in r:
                print(f"[skipped-by-rule] {name}: {r['skipped']}",
                      flush=True)
                continue
            mem = r["memory"]["bytes_per_device"]
            mb = "n/a" if mem is None else f"{mem / 2**30:.2f}GiB"
            print(f"[ok] {name}: compile={r['compile_s']}s "
                  f"mem/dev={mb} dominant={r['roofline']['dominant']} "
                  f"useful={r['useful_flops_frac']:.2f}", flush=True)
        except Exception as e:  # noqa: BLE001 -- reported, then exit 1
            failed += 1
            print(f"[FAIL] {name}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
