"""The hand-written CUDA SSD intra-chunk kernel: binding and wrapper.

`csrc/ssd_intra.cu` is the Hopper counterpart of the Pallas TPU kernel
`repro.kernels.ssd.ssd.ssd_intra_pallas`: 3xTF32 tensor-core products
(wgmma, and mma.sync for G; f32 accumulation) with one G = C.B^T panel
shared by a group of heads. Its header says what bounds it and how the
design answers that. It is built at first use by
`repro_torch.kernels._build` and launched on PyTorch's current stream.
The plain PyTorch version of the same function is `ref.ssd_intra_ref`.

`ssd_cuda` mirrors `ssd_pallas`: the cumulative decay, the inter-chunk
recurrence (a loop over chunks), `y_inter` and the `D` skip stay in
torch around the kernel.

The kernel has no backward yet (ROADMAP item 11.3): both wrappers raise
under grad mode when an input requires grad, so no mamba layer on the
card can silently lose its gradient.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import require_no_grad
from repro_torch.kernels.ssd.ref import chunk_inputs, ssd_from_intra

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_intra.cu"
MAX_STATE = 128             # N: two warpgroups x 64 state rows
MAX_HEAD_DIM = 128          # P: two 64-column slots per head
MAX_CHUNK = 256             # Q: the G panel of a 64-row tile fits in smem
HEAD_GROUP = 8              # heads that share one G = C.B^T panel
K3_BACKWARD = ("the K3 backward is not ported yet: ROADMAP item 11.3, "
               "training mamba layers on the card")
ROUTE = (f"3xTF32 tensor cores, f32 accumulate (wgmma m64n64k8 for y and S, "
         f"mma.sync m16n8k8 for G); G = C.B^T shared by {HEAD_GROUP} heads")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.ssd_intra_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_intra_launch.restype = ctypes.c_int
    lib.ssd_intra_error_string.argtypes = [ctypes.c_int]
    lib.ssd_intra_error_string.restype = ctypes.c_char_p
    return lib


def ssd_intra_cuda(C: torch.Tensor, B: torch.Tensor, dtx: torch.Tensor,
                   cums: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The intra-chunk form on the card. C/B: (b,nc,Q,N); dtx:
    (b,nc,Q,H,P); cums: (b,nc,Q,H); all contiguous f32 CUDA tensors,
    Q <= 256, N <= 128, P <= 128. Returns (y_intra (b,nc,Q,H,P),
    S (b,nc,H,N,P)), f32. One call launches the kernel's two functions
    (y, then S) and counts once. Raises on anything the kernel does not
    take, and under grad mode when an input requires grad; never falls
    back to the plain version."""
    require_no_grad("ssd_intra_cuda", K3_BACKWARD, C, B, dtx, cums)
    tensors = {"C": C, "B": B, "dtx": dtx, "cums": cums}
    if not all(x.is_cuda for x in tensors.values()):
        raise ValueError("ssd_intra_cuda needs CUDA tensors; the plain "
                         "version is ref.ssd_intra_ref")
    if C.ndim != 4 or B.shape != C.shape or dtx.ndim != 5 or cums.ndim != 4:
        raise ValueError(f"ssd_intra_cuda: C {tuple(C.shape)}, B "
                         f"{tuple(B.shape)}, dtx {tuple(dtx.shape)}, cums "
                         f"{tuple(cums.shape)} are not (b,nc,Q,N) x2, "
                         "(b,nc,Q,H,P), (b,nc,Q,H)")
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    if tuple(dtx.shape[:3]) != (b, nc, q) or tuple(cums.shape) != (
            b, nc, q, h):
        raise ValueError(f"ssd_intra_cuda: dtx {tuple(dtx.shape)} / cums "
                         f"{tuple(cums.shape)} do not fit C "
                         f"{tuple(C.shape)}")
    if not (1 <= n <= MAX_STATE and 1 <= p <= MAX_HEAD_DIM
            and 1 <= q <= MAX_CHUNK):
        raise ValueError(f"ssd_intra_cuda: state {n} / head dim {p} / "
                         f"chunk {q} outside 1..{MAX_STATE} / "
                         f"1..{MAX_HEAD_DIM} / 1..{MAX_CHUNK}")
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise ValueError(f"ssd_intra_cuda: {name} has dtype {x.dtype}, "
                             "expected float32")
        if x.device != C.device:
            raise ValueError(f"ssd_intra_cuda: {name} is on {x.device}, "
                             f"expected {C.device}")
        if not x.is_contiguous():
            raise ValueError(f"ssd_intra_cuda: {name} is not contiguous")
    if C.numel() == 0 or dtx.numel() == 0:
        raise ValueError("ssd_intra_cuda: empty input")
    y = torch.empty_like(dtx)
    S = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=C.device)
    lib = _library()
    with torch.cuda.device(C.device):
        err = lib.ssd_intra_launch(
            C.data_ptr(), B.data_ptr(), dtx.data_ptr(), cums.data_ptr(),
            y.data_ptr(), S.data_ptr(), b * nc, q, n, h, p,
            torch.cuda.current_stream(C.device).cuda_stream)
    if err:
        raise RuntimeError(
            "ssd_intra kernel launch failed: "
            f"{lib.ssd_intra_error_string(err).decode()} ({err})")
    ssd_intra_cuda.launches += 1
    return y, S


ssd_intra_cuda.launches = 0          # kernel launches since the last reset


def ssd_cuda(x, dt, Bm, Cm, A_log, D, chunk: int = 64, h0=None):
    """Full SSD with the CUDA intra-chunk kernel (same contract as
    `ref.ssd_ref`). Raises under grad mode when an input requires grad."""
    require_no_grad("ssd_cuda", K3_BACKWARD, x, dt, Bm, Cm, A_log, D, h0)
    C_c, B_c, dtx, cums = chunk_inputs(x, dt, Bm, Cm, A_log, chunk)
    y_intra, S = ssd_intra_cuda(C_c.contiguous(), B_c.contiguous(), dtx,
                                cums)
    return ssd_from_intra(x, D, C_c, cums, y_intra, S, h0)
