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
from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.attention.ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """K2 under autograd: the forward kernel, saving q, k, v and its
    output; the backward kernel for (dq, dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        o = flash_attention_cuda(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do.contiguous(),
                                              ctx.causal, ctx.window)
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
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)
