"""Step factories and shardings of the port (the counterpart of
`repro.launch.steps`): the train step that the trainer (`launch.train`)
and `chip_smoke.py` call, the prefill and decode steps of the serving
launcher, and the sharding surface of a device mesh.

`param_shardings`, `opt_shardings`, `batch_shardings`, `cache_shardings`
and `train_state_shardings` give each leaf a `NamedSharding` from its
logical axes (`distributed.sharding`), in the port's layout: parameters by
name (one module per layer, no stacked `layers` axis), caches one dict
per layer. `input_specs` returns meta tensors for every model input of an
(arch x shape) cell, the counterpart of `ShapeDtypeStruct`s.
`shard_state` and `shard_batch` distribute a one-device state or batch
onto a mesh; under `distributed.mesh_context` the train step is then the
same function on each rank's shards.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              PartitionSpec, ShardingRules,
                                              logical_to_pspec)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES, DeclModule
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


# --------------------------------------------------------------------- #
# shardings from declarations
# --------------------------------------------------------------------- #
def param_decls(cfg: ModelConfig) -> dict:
    """{parameter name (as `LM.named_parameters` gives it): ParamDecl}."""
    out = {}
    for prefix, mod in M.abstract_params(cfg).named_modules():
        if isinstance(mod, DeclModule):
            for name, decl in mod.decls.items():
                out[f"{prefix}.{name}"] = decl
    return out


def param_shardings(cfg: ModelConfig, mesh,
                    rules: ShardingRules = DEFAULT_RULES) -> dict:
    """{parameter name: NamedSharding} (strict: exact divisibility)."""
    return {n: NamedSharding(mesh, logical_to_pspec(
        d.shape, d.logical_axes, mesh, rules))
        for n, d in param_decls(cfg).items()}


def opt_shardings(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                  rules: ShardingRules = DEFAULT_RULES) -> dict:
    """The moments take the parameters' shardings; the step is
    replicated."""
    del opt_cfg
    ps = param_shardings(cfg, mesh, rules)
    return {"mu": ps, "nu": ps, "step": NamedSharding(mesh, PartitionSpec())}


BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", None),
}


def batch_shardings(specs: dict, mesh,
                    rules: ShardingRules = DEFAULT_RULES) -> dict:
    """NamedShardings for a batch dict (real shapes, so divisibility
    fallbacks resolve correctly)."""
    return {k: NamedSharding(mesh, logical_to_pspec(
        v.shape, BATCH_AXES[k], mesh, rules)) for k, v in specs.items()}


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                    rules: ShardingRules = DEFAULT_RULES,
                    long_ctx: bool = False) -> list[dict]:
    axes = M.cache_logical_axes(cfg, long_ctx=long_ctx)
    abstract = M.abstract_cache(cfg, batch, max_seq, long_ctx=long_ctx)
    return [{k: NamedSharding(mesh, logical_to_pspec(a.shape, ax[k], mesh,
                                                     rules))
             for k, a in layer.items()}
            for layer, ax in zip(abstract, axes)]


# --------------------------------------------------------------------- #
# abstract inputs per (arch x shape) cell
# --------------------------------------------------------------------- #
def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                step: str, long_ctx: bool = False) -> dict:
    """Meta tensors for one cell: {"batch": {...}} for train and prefill,
    {"cache", "tokens", "pos"} for decode (one new token against a
    seq_len-deep cache)."""
    meta = dict(device=torch.device("meta"))
    i32 = torch.int32
    if step in ("train", "prefill"):
        ids = torch.empty((global_batch, seq_len), dtype=i32, **meta)
        if cfg.frontend == "frames":
            batch = {"frames": torch.empty(
                (global_batch, seq_len, cfg.d_model),
                dtype=DTYPES[cfg.activation_dtype], **meta),
                "labels": ids}
        else:
            batch = {"tokens": ids,
                     "labels": torch.empty_like(ids)}
        return {"batch": batch}
    return {
        "cache": M.abstract_cache(cfg, global_batch, seq_len,
                                  long_ctx=long_ctx),
        "tokens": torch.empty((global_batch, 1), dtype=i32, **meta),
        "pos": torch.empty((global_batch,), dtype=i32, **meta),
    }


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> dict:
    ap = M.abstract_params(cfg)
    return {"params": ap, "opt": adamw.abstract_opt_state(ap, opt_cfg)}


def train_state_shardings(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                          rules: ShardingRules = DEFAULT_RULES) -> dict:
    return {"params": param_shardings(cfg, mesh, rules),
            "opt": opt_shardings(cfg, mesh, opt_cfg, rules)}


# --------------------------------------------------------------------- #
# one device -> mesh
# --------------------------------------------------------------------- #
def _distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    return distribute_tensor(t, sharding.mesh, sharding.placements)


@torch.no_grad()
def shard_state(state: dict, cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                rules: ShardingRules = DEFAULT_RULES) -> dict:
    """Distribute a one-device train state onto `mesh`, in place: each
    parameter of the `LM` becomes a DTensor parameter in its
    `param_shardings` placements, the moments (and a compression
    feedback) take the same, the step is replicated. Every rank passes
    the same state (rank 0's is what lands); collective. Returns
    `state`."""
    shard = train_state_shardings(cfg, mesh, opt_cfg, rules)
    ps = shard["params"]
    for prefix, mod in state["params"].named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = nn.Parameter(
                _distribute(p.detach(), ps[full]), requires_grad=False)
    for key in ("mu", "nu"):
        state["opt"][key] = {n: _distribute(t, ps[n])
                             for n, t in state["opt"][key].items()}
    state["opt"]["step"] = _distribute(state["opt"]["step"],
                                       shard["opt"]["step"])
    if "feedback" in state:
        state["feedback"] = {n: _distribute(t, ps[n])
                             for n, t in state["feedback"].items()}
    return state


def shard_batch(batch: dict, mesh,
                rules: ShardingRules = DEFAULT_RULES) -> dict:
    """Distribute a one-device batch (the global batch, alike on every
    rank) onto `mesh` by `BATCH_AXES`; collective."""
    return {k: _distribute(v, s)
            for (k, v), s in zip(batch.items(),
                                 batch_shardings(batch, mesh, rules)
                                 .values())}


# --------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------- #
def _in_placements(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements (a reduce-scatter or an
    all-reduce of a partial sum, a slice of a replicated one)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    impl: str = "auto", moe_dispatch: str = "gspmd",
                    remat: bool = True, grad_compression=None, device=None):
    """(state, batch) -> (state, metrics). state = {"params": LM, "opt":
    `adamw.init_opt_state`'s dict}, plus "feedback" with
    `grad_compression` (`distributed.compression.compress_grads`). The
    parameters and moments are updated in place and the same dicts are
    returned. metrics = {"loss", "lr", "grad_norm"}, device tensors (read
    them on the host only when logging). batch holds "tokens" (or
    "frames") and "labels" on the parameters' device.

    Under a device mesh (`distributed.mesh_context`, the state from
    `shard_state`, the batch from `shard_batch`) it is the same function
    on each rank's shards: the gradients come back in the parameters'
    placements, AdamW updates the DTensor moments in place, and the loss
    and `grad_norm` are global (alike on every rank).

    `impl` is accepted for parity with the reference: the tensors' device
    picks the attention route (K2 under autograd on the card, its fake
    implementation on meta and fake tensors, `attention_ref` on the CPU;
    K3 under autograd through `ssd.ops.SSDIntra` on the card, `ssd_ref`
    on the CPU). `moe_dispatch` picks the MoE's dispatch: "gspmd" (the
    grouped dispatch) or "all_to_all" (expert parallelism over the mesh's
    `model` axis, `distributed.moe_ep`; differentiable). Every config
    trains on either device, as in the reference. `device` (default: the
    CUDA device, which must exist) is where the caller will place the
    state."""
    del impl
    resolve_device(device, "make_train_step")

    def train_step(state, batch):
        params = state["params"]
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss = M.train_loss(params, batch, cfg, remat=remat,
                                moe_dispatch=moe_dispatch)
            if isinstance(loss, DTensor):
                loss = loss.full_tensor()
            # a `frames` model declares an embedding it never reads
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None
                 else _in_placements(g, p)
                 for (n, p), g in zip(named.items(), grads)}
        if grad_compression is not None:
            grads, feedback = grad_compression(grads, state.get("feedback"))
        _, opt, stats = adamw.adamw_update(grads, state["opt"], params,
                                           opt_cfg)
        new_state = {"params": params, "opt": opt}
        if grad_compression is not None:
            new_state["feedback"] = feedback
        return new_state, {"loss": loss.detach(), **stats}

    return train_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto",
                      moe_dispatch: str = "gspmd"):
    """(params, batch) -> last-position logits (B,1,V) f32. batch holds
    "tokens" (B,S), or "frames" (B,S,d) for the `frames` frontend. `impl`
    is accepted for parity with the reference (the tensors' device picks
    the attention route); `moe_dispatch` as `make_train_step`'s."""
    del impl

    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, moe_dispatch=moe_dispatch)
    return prefill_step


def make_decode_step(cfg: ModelConfig, long_ctx: bool = False,
                     moe_dispatch: str = "gspmd"):
    """(params, cache, tokens, pos) -> (logits (B,1,V) f32, cache). With
    `long_ctx` the caches' T axis is split over `long_kv_seq` under a
    mesh (`cache_shardings(..., long_ctx=True)`)."""
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg,
                             long_ctx=long_ctx, moe_dispatch=moe_dispatch)
    return serve_step
