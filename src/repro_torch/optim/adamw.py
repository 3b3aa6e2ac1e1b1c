"""Hand-rolled AdamW + cosine schedule: the port of `repro.optim.adamw`.

The arithmetic is the reference's: the gradients are clipped by
``min(1, clip_norm / max(global_norm, 1e-9))``; the moments are updated
in f32 and stored in `moment_dtype` (f32, or bf16 to halve optimizer
memory); the bias corrections come from the step; weight decay is
decoupled; the new parameter is cast back to the parameter's own dtype.
There are no f32 master weights, as in the reference.

The update works IN PLACE (the reference returns new trees): on the
parameters of an `nn.Module` (the `LM`) or a dict of tensors, and on the
moment dicts ``{"mu": {name: tensor}, "nu": {...}, "step": int32}`` keyed
by parameter name, so training holds one copy of each. The step and the
learning rate stay device tensors: no host read per step. `torch.optim`
is not used.

Under a device mesh the parameters, gradients and moments are DTensors
in the parameters' placements: the global norm is DTensor's (a reduction
over every shard), and the update, elementwise, runs on each rank's local
shards in place. `abstract_opt_state` describes the state on the meta
device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # or "bfloat16" for big models


def cosine_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to `lr_peak`, then a cosine down to `lr_min_ratio` of
    it, in f32. `step` is a number or a tensor (the result lives on its
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * cos
    return cfg.lr_peak * warm * scale


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def named_params(params) -> dict[str, torch.Tensor]:
    """{name: tensor} of an `nn.Module`'s parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments in `moment_dtype`, one per parameter name, and step 0
    (int32), on the parameters' devices."""
    named = named_params(params)
    md = _mdtype(cfg)
    dev = next(iter(named.values())).device
    return {
        "mu": {n: torch.zeros(p.shape, dtype=md, device=p.device)
               for n, p in named.items()},
        "nu": {n: torch.zeros(p.shape, dtype=md, device=p.device)
               for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_opt_state(abstract_params, cfg: AdamWConfig) -> dict:
    """`init_opt_state`'s structure on the meta device (`abstract_params`
    may be `models.model.abstract_params`): shapes and dtypes, no
    storage."""
    named = named_params(abstract_params)
    md = _mdtype(cfg)
    meta = torch.device("meta")
    return {
        "mu": {n: torch.empty(p.shape, dtype=md, device=meta)
               for n, p in named.items()},
        "nu": {n: torch.empty(p.shape, dtype=md, device=meta)
               for n, p in named.items()},
        "step": torch.empty((), dtype=torch.int32, device=meta),
    }


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _square_norm(t: torch.Tensor) -> torch.Tensor:
    sq = torch.linalg.vector_norm(t, dtype=torch.float32).square()
    return sq.full_tensor() if isinstance(sq, DTensor) else sq


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of `tree` ({name:
    tensor}), in f32 (over every shard of a DTensor: a plain tensor,
    alike on every rank)."""
    return torch.stack([_square_norm(t) for t in tree.values()]
                       ).sum().sqrt()


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step, in place. `grads` maps each parameter name to its
    gradient. Returns ``(params, opt_state, stats)``, the first two being
    the objects passed in (updated), stats ``{"lr", "grad_norm"}`` as
    device tensors (the norm before clipping)."""
    named = named_params(params)
    if set(grads) != set(named):
        raise ValueError(f"gradients {sorted(set(grads) ^ set(named))} do "
                         "not match the parameters")
    step_in = opt_state["step"]
    step = _local(step_in) + 1
    lr = cosine_schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    for name, p in named.items():
        p = _local(p)
        mu, nu = (_local(opt_state[m][name]) for m in ("mu", "nu"))
        g = _local(grads[name]).float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g.square()
        delta = (mu32 / bc1) / ((nu32 / bc2).sqrt() + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        mu.copy_(mu32)
        nu.copy_(nu32)
    if isinstance(step_in, DTensor):
        step = DTensor.from_local(step, step_in.device_mesh,
                                  step_in.placements, run_check=False)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
