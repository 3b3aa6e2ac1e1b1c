"""Public flash attention op: the CUDA kernels on the card, the plain
version on the CPU (the port of `repro.kernels.attention.ops`).

On CUDA tensors that autograd records (grad mode on, an input requiring
grad), `FlashAttention` joins K2's forward (`flash_attention_cuda`) to its
hand-written backward (`flash_attention_bwd_cuda`); otherwise the forward
kernel runs alone. CPU tensors take `attention_ref` and PyTorch's autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._grad import records_grad
from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """K2 under autograd: the forward kernel, saving q, k, v, its output
    and, when the backward's route (`flash.bwd_route`) is "wgmma", the row
    log-sum-exp the forward writes beside it; the backward kernel of that
    route for (dq, dk, dv). Under a non-reentrant checkpoint the saved L is
    the recomputed forward's, like the other saved tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        if flash.bwd_route(q.dtype, q.shape[-1]) == "wgmma":
            o, lse = flash.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window,
                                                return_lse=True)
        else:
            o = flash.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
            lse = None
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash.flash_attention_bwd_cuda(
            q, k, v, o, do.contiguous(), ctx.causal, ctx.window, lse=lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,T,KH,hd). On CUDA tensors this launches the
    kernels (through `FlashAttention` when autograd records the call) or
    raises; on CPU tensors it runs `attention_ref`."""
    if q.is_cuda:
        if records_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
