"""Public op for the SSD layer (the port of `repro.kernels.ssd.ops`):
the CUDA intra-chunk kernel on CUDA tensors, the plain chunked form on
CPU tensors. Both run the same chunk structure (`ref.ssd_with_intra`).

K3's forward and backward are `torch.library` custom ops,
``torch.ops.repro_torch.ssd_intra`` and ``..._bwd``: on CUDA tensors
each calls today's wrapper (`ssd.ssd_intra_cuda`, `ssd.ssd_intra_bwd_cuda`:
the same source, grid and launch count), on CPU tensors the plain
version (`ssd_intra_ref`, `ssd_intra_bwd_ref`), and on meta or fake
tensors its fake implementation (the outputs' shapes and dtypes, after
the wrapper's limits are checked). Each op carries its FLOP formula
(`kernels.cost`).

On CUDA, meta and fake tensors (`kernels._grad.kernel_route`)
`ssd_chunked` runs `SSDIntra`, which joins the forward op to the backward
op, and the torch glue around it (`chunk_inputs`, `ssd_from_intra`) stays
under autograd. Under no_grad the Function runs the forward alone and
records nothing. Plain CPU tensors take `ssd_ref` and PyTorch's
autograd."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cost
from repro_torch.kernels._grad import kernel_route
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd.ref import (ssd_intra_bwd_ref, ssd_intra_ref,
                                         ssd_ref, ssd_with_intra)


def _check_fake(op: str, C, dtx) -> None:
    """The wrapper's limits, checked on shapes (`ssd._check`'s)."""
    q, n, p = C.shape[2], C.shape[3], dtx.shape[4]
    if not (1 <= n <= ssd.MAX_STATE and 1 <= p <= ssd.MAX_HEAD_DIM
            and 1 <= q <= ssd.MAX_CHUNK):
        raise ValueError(f"{op}: state {n} / head dim {p} / chunk {q} "
                         f"outside 1..{ssd.MAX_STATE} / 1..{ssd.MAX_HEAD_DIM}"
                         f" / 1..{ssd.MAX_CHUNK}")
    if C.dtype != torch.float32 or dtx.dtype != torch.float32:
        raise ValueError(f"{op}: dtypes {C.dtype}, {dtx.dtype}; the kernel "
                         "takes float32")


@torch.library.custom_op("repro_torch::ssd_intra", mutates_args=(),
                         device_types="cpu")
def ssd_intra(C: torch.Tensor, B: torch.Tensor, dtx: torch.Tensor,
              cums: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's forward: (y_intra (b,nc,Q,H,P), S (b,nc,H,N,P)), f32. This
    body is the CPU implementation, the plain version."""
    return tuple(t.contiguous() for t in ssd_intra_ref(C, B, dtx, cums))


@ssd_intra.register_kernel("cuda")
def _ssd_intra_cuda(C, B, dtx, cums):
    return ssd.ssd_intra_cuda(C, B, dtx, cums)


@ssd_intra.register_fake
def _ssd_intra_fake(C, B, dtx, cums):
    _check_fake("ssd_intra", C, dtx)
    b, nc, _, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    return torch.empty_like(dtx), dtx.new_empty((b, nc, h, n, p))


@torch.library.custom_op("repro_torch::ssd_intra_bwd", mutates_args=(),
                         device_types="cpu")
def ssd_intra_bwd(C: torch.Tensor, B: torch.Tensor, dtx: torch.Tensor,
                  cums: torch.Tensor, dy: torch.Tensor, dS: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """K3's backward: (dC, dB, ddtx, dcums) for the cotangents dy, dS.
    This body is the CPU implementation, the plain version."""
    return tuple(t.contiguous()
                 for t in ssd_intra_bwd_ref(C, B, dtx, cums, dy, dS))


@ssd_intra_bwd.register_kernel("cuda")
def _ssd_intra_bwd_cuda(C, B, dtx, cums, dy, dS):
    return ssd.ssd_intra_bwd_cuda(C, B, dtx, cums, dy, dS)


@ssd_intra_bwd.register_fake
def _ssd_intra_bwd_fake(C, B, dtx, cums, dy, dS):
    _check_fake("ssd_intra_bwd", C, dtx)
    return (torch.empty_like(C), torch.empty_like(B), torch.empty_like(dtx),
            torch.empty_like(cums))


register_flop_formula(torch.ops.repro_torch.ssd_intra)(cost.ssd_fwd_formula)
register_flop_formula(torch.ops.repro_torch.ssd_intra_bwd)(
    cost.ssd_bwd_formula)


class SSDIntra(torch.autograd.Function):
    """K3 under autograd: the forward op, saving C, B, dtx and cums; the
    backward op for (dC, dB, ddtx, dcums) from the cotangents of y_intra
    and S. Under a non-reentrant checkpoint the saved tensors are the
    recomputed forward's."""

    @staticmethod
    def forward(ctx, C, B, dtx, cums):
        y, S = torch.ops.repro_torch.ssd_intra(C, B, dtx, cums)
        ctx.save_for_backward(C, B, dtx, cums)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        C, B, dtx, cums = ctx.saved_tensors
        return torch.ops.repro_torch.ssd_intra_bwd(
            C, B, dtx, cums, dy.contiguous(), dS.contiguous())


def ssd_chunked(x, dt, Bm, Cm, A_log, D, chunk: int = 64, h0=None):
    """x: (B,L,H,P); dt: (B,L,H); Bm/Cm: (B,L,N). On CUDA tensors this
    launches K3 through `SSDIntra` (its backward too, when autograd
    records the call) or raises; on meta and fake tensors it takes the
    same ops' fake implementations; on CPU tensors it runs `ssd_ref`."""
    if not kernel_route(x):
        return ssd_ref(x, dt, Bm, Cm, A_log, D, chunk=chunk, h0=h0)
    return ssd_with_intra(SSDIntra.apply, x, dt, Bm, Cm, A_log, D,
                          chunk=chunk, h0=h0)
