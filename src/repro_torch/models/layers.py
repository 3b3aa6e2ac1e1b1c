"""Shared layer primitives and the parameter declaration system.

The counterpart of `repro.models.layers`. A block declares each tensor
once (`ParamDecl`: shape, logical axes, init); `DeclModule` turns the
declarations into `nn.Parameter`s of that shape and `init_module` fills
every declared tensor of a module tree from one `torch.Generator`, with
the reference's scales: fan-in ``1/sqrt(shape[0])`` by default, an
explicit `scale` where given, 1 for `embed`, and constant `zeros`/`ones`.
The two frameworks draw different numbers from one seed; tests carry the
reference's own tensors across with `repro_torch.models.convert`.

`swiglu` states the reference's sequence-parallel transitions with
`distributed.sharding.constrain` (the identity without a device mesh).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import constrain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple
    logical_axes: tuple
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # fan-in default when None


def init_param(gen: torch.Generator, decl: ParamDecl, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=device)
    scale = (decl.scale if decl.scale is not None
             else 1.0 / math.sqrt(decl.shape[0]))
    if decl.init == "embed":
        scale = 1.0
    x = torch.randn(decl.shape, generator=gen, dtype=torch.float32,
                    device=device)
    # in place: one f32 copy of the tensor at a time (a jamba expert
    # stack is 12.9 GB in f32)
    return x.mul_(scale).to(dtype)


class DeclModule(nn.Module):
    """A module whose parameters are a flat dict of `ParamDecl`s,
    allocated (uninitialised) on `device` in `dtype`."""

    def __init__(self, decls: dict, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.decls = decls
        for name, d in decls.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(d.shape, dtype=dtype, device=device),
                requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


@torch.no_grad()
def init_module(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every declared parameter of `module`'s tree, in module order
    then declaration order, from `gen`."""
    for m in module.modules():
        if isinstance(m, DeclModule):
            for name, d in m.decls.items():
                p = getattr(m, name)
                p.copy_(init_param(gen, d, p.dtype, p.device))
    return module


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with the reference's ``1 + gamma`` scale, in f32, back to
    x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE on the split-half layout. q/k: (..., S, H, D); positions:
    (..., S)."""
    d = q.shape[-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    # all in f32, in the reference's order
    freqs = torch.exp(-torch.arange(0, d, 2, **f32) / d
                      * torch.log(torch.full((), theta, **f32)))
    ang = positions[..., :, None].float() * freqs        # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]                # over heads
    sin = torch.sin(ang)[..., :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor, act_axis: str = "act_mlp") -> torch.Tensor:
    """SwiGLU FFN: (silu(x W_gate) * x W_in) W_out; weights (d, f), (f, d).
    Under a mesh: the sequence gathered on entry, tensor-parallel over
    the ffn axis, and the caller's residual constraint scatters the
    output back (the Megatron SP pattern, as the reference states it)."""
    x = constrain(x, "batch", None, None)
    h = F.silu(x @ w_gate) * (x @ w_in)
    h = constrain(h, "batch", None, act_axis)
    return h @ w_out
