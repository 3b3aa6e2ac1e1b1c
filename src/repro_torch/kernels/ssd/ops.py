"""Public op for the SSD layer (the port of `repro.kernels.ssd.ops`):
the CUDA intra-chunk kernel on CUDA tensors, the plain chunked form on
CPU tensors. Both run the same chunk structure (`ref.ssd_with_intra`).

On CUDA tensors `SSDIntra` joins K3's forward (`ssd_intra_cuda`) to its
hand-written backward (`ssd_intra_bwd_cuda`), and the torch glue around
it (`chunk_inputs`, `ssd_from_intra`) stays under autograd. Under
no_grad the Function launches the forward alone and records nothing.
CPU tensors take `ssd_ref` and PyTorch's autograd."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_with_intra


class SSDIntra(torch.autograd.Function):
    """K3 under autograd: the forward kernel, saving C, B, dtx and cums;
    the backward kernel for (dC, dB, ddtx, dcums) from the cotangents of
    y_intra and S. Under a non-reentrant checkpoint the saved tensors are
    the recomputed forward's."""

    @staticmethod
    def forward(ctx, C, B, dtx, cums):
        y, S = ssd.ssd_intra_cuda(C, B, dtx, cums)
        ctx.save_for_backward(C, B, dtx, cums)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        C, B, dtx, cums = ctx.saved_tensors
        return ssd.ssd_intra_bwd_cuda(C, B, dtx, cums, dy.contiguous(),
                                      dS.contiguous())


def ssd_chunked(x, dt, Bm, Cm, A_log, D, chunk: int = 64, h0=None):
    """x: (B,L,H,P); dt: (B,L,H); Bm/Cm: (B,L,N). On CUDA tensors this
    launches K3 through `SSDIntra` (its backward too, when autograd
    records the call) or raises; on CPU tensors it runs `ssd_ref`."""
    if not x.is_cuda:
        return ssd_ref(x, dt, Bm, Cm, A_log, D, chunk=chunk, h0=h0)
    return ssd_with_intra(SSDIntra.apply, x, dt, Bm, Cm, A_log, D,
                          chunk=chunk, h0=h0)
