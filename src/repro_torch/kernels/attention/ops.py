"""Public flash attention op: the CUDA kernels on the card, the plain
version on the CPU (the port of `repro.kernels.attention.ops`).

K2's forward and backward are `torch.library` custom ops,
``torch.ops.repro_torch.flash_attention_fwd`` and ``..._bwd``: on CUDA
tensors each calls today's wrapper (`flash.flash_attention_cuda`,
`flash.flash_attention_bwd_cuda`: the same source, route, grid and launch
count), on CPU tensors the plain version (`attention_ref` with
`attention_lse_ref`, `attention_bwd_ref`), and on meta or fake tensors its
fake implementation, which gives the outputs' shapes and dtypes after
checking the route as the wrapper would. Each op carries its FLOP formula
(`kernels.cost`), so `torch.utils.flop_counter.FlopCounterMode` and the
dry-run count the kernel's work and not the plain version's.

`flash_attention` takes the ops on CUDA, meta and fake tensors
(`kernels._grad.kernel_route`): through `FlashAttention` when autograd
records the call (grad mode on, an input requiring grad), which joins the
forward op to the backward op; otherwise the forward op alone. Plain CPU
tensors take `attention_ref` and PyTorch's autograd, as before.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cost
from repro_torch.kernels._grad import kernel_route, records_grad
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)

_NO_LSE = (0,)          # the forward op's second output when L is not asked


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: Optional[int],
                        return_lse: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's forward: (out (B,S,H,hd), L (B,H,S) f32 when `return_lse`,
    else an empty f32 tensor). This body is the CPU implementation, the
    plain version."""
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = (attention_lse_ref(q, k, causal, window) if return_lse
           else q.new_empty(_NO_LSE, dtype=torch.float32))
    return o.contiguous(), lse.contiguous()


@flash_attention_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, window, return_lse):
    if return_lse:
        return flash.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, return_lse=True)
    o = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return o, q.new_empty(_NO_LSE, dtype=torch.float32)


@flash_attention_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, window, return_lse):
    name = flash.route(q.dtype, q.shape[-1])
    if return_lse and name not in flash.LSE_ROUTES:
        raise ValueError("flash_attention_fwd: return_lse needs a route of "
                         f"{flash.LSE_ROUTES}; {q.dtype} at hd "
                         f"{q.shape[-1]} takes {name!r}")
    b, s, h = q.shape[:3]
    lse = (q.new_empty((b, h, s), dtype=torch.float32) if return_lse
           else q.new_empty(_NO_LSE, dtype=torch.float32))
    return torch.empty_like(q), lse


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: Optional[torch.Tensor], causal: bool,
                        window: Optional[int]
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's backward: (dq, dk, dv) for the output gradient `do`; `lse` is
    the forward's L where the backward's route takes it. This body is the
    CPU implementation, the plain version (which recomputes L)."""
    return tuple(g.contiguous() for g in attention_bwd_ref(
        q, k, v, o, do, causal=causal, window=window))


@flash_attention_bwd.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, o, do, lse, causal, window):
    return flash.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                          lse=lse)


@flash_attention_bwd.register_fake
def _flash_bwd_fake(q, k, v, o, do, lse, causal, window):
    name = flash.bwd_route(q.dtype, q.shape[-1])
    takes_lse = name in flash.LSE_ROUTES
    if takes_lse != (lse is not None):
        raise ValueError(f"flash_attention_bwd: the {name} backward "
                         + ("takes the forward's L" if takes_lse
                            else "recomputes L; pass lse=None"))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)(
    cost.flash_fwd_formula)
register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)(
    cost.flash_bwd_formula)


class FlashAttention(torch.autograd.Function):
    """K2 under autograd: the forward op, saving q, k, v, its output and,
    when the backward's route (`flash.bwd_route`) takes it ("tf32x3",
    "wgmma": `flash.LSE_ROUTES`), the row log-sum-exp the forward writes
    beside it; the backward op of that route for (dq, dk, dv). Under a
    non-reentrant checkpoint the saved L is the recomputed forward's, like
    the other saved tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        want_lse = flash.bwd_route(q.dtype, q.shape[-1]) in flash.LSE_ROUTES
        o, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, window, want_lse)
        ctx.save_for_backward(q, k, v, o, lse if want_lse else None)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, o, do.contiguous(), lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,KH,hd). On CUDA tensors this launches the
    kernels (through `FlashAttention` when autograd records the call) or
    raises; on meta and fake tensors it takes the same ops' fake
    implementations; on CPU tensors it runs `attention_ref`."""
    if kernel_route(q):
        if records_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        return torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, window, False)[0]
    return attention_ref(q, k, v, causal=causal, window=window)
