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

`csrc/ssd_intra_bwd.cu` is the backward of the same function (the
reference differentiates its jnp form; it has no backward kernel of its
own): 3xTF32 products on the tensor cores (wgmma for dAtt and att^T.dY
where P <= 64, mma.sync elsewhere), G shared by a group of heads, the
diagonal's sub-tiles wholly above it skipped, no atomics, wrapped by
`ssd_intra_bwd_cuda`; its plain version is `ref.ssd_intra_bwd_ref`. Every
shape the wrapper takes goes to the tensor cores.
`ops.SSDIntra` joins the two under autograd. The raw wrappers here carry
no gradient, so they raise under grad mode when an input requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import require_no_grad
from repro_torch.kernels.ssd.ref import ssd_with_intra

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_intra.cu"
BWD_SOURCE = SOURCE.with_name("ssd_intra_bwd.cu")
MAX_STATE = 128             # N: two warpgroups x 64 state rows
MAX_HEAD_DIM = 128          # P: two 64-column slots per head
MAX_CHUNK = 256             # Q: the G panel of a 64-row tile fits in smem
HEAD_GROUP = 8              # heads that share one G = C.B^T panel
K3_BACKWARD = ("the gradient through K3 is taken by ops.SSDIntra, which "
               "ops.ssd_chunked runs on CUDA tensors")
ROUTE = (f"3xTF32 tensor cores, f32 accumulate (wgmma m64n64k8 for y and S, "
         f"mma.sync m16n8k8 for G); G = C.B^T shared by {HEAD_GROUP} heads")
BWD_ROUTE = (f"3xTF32 tensor cores, f32 accumulate: ssd_bwd_dxw (P <= 64: "
             f"wgmma m64n32k8 for dAtt and att^T.dY, mma.sync m16n8k8 for "
             f"G and B.dS) or ssd_bwd_dx (P > 64: mma.sync) with G shared "
             f"by {HEAD_GROUP} heads, ddtx and dG^T per group; "
             f"ssd_bwd_dgsum (the groups' dG^T in order); ssd_bwd_dcdb "
             f"(mma.sync: dC, dB with its state term as one H.P-long "
             f"product, dcums); no atomics")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.ssd_intra_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_intra_launch.restype = ctypes.c_int
    lib.ssd_intra_error_string.argtypes = [ctypes.c_int]
    lib.ssd_intra_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    lib.ssd_intra_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_intra_bwd_launch.restype = ctypes.c_int
    lib.ssd_intra_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.ssd_intra_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.ssd_intra_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_intra_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(op: str, tensors: dict) -> tuple[int, int, int, int, int, int]:
    """The checks both wrappers share: shapes, limits, CUDA, f32, one
    device, contiguous, non-empty. `tensors` holds C, B, dtx, cums and,
    for the backward, dy and dS. Returns (b, nc, Q, N, H, P)."""
    C, B, dtx, cums = (tensors[k] for k in ("C", "B", "dtx", "cums"))
    if C.ndim != 4 or B.shape != C.shape or dtx.ndim != 5 or cums.ndim != 4:
        raise ValueError(f"{op}: C {tuple(C.shape)}, B "
                         f"{tuple(B.shape)}, dtx {tuple(dtx.shape)}, cums "
                         f"{tuple(cums.shape)} are not (b,nc,Q,N) x2, "
                         "(b,nc,Q,H,P), (b,nc,Q,H)")
    b, nc, q, n = C.shape
    h, p = dtx.shape[3], dtx.shape[4]
    if tuple(dtx.shape[:3]) != (b, nc, q) or tuple(cums.shape) != (
            b, nc, q, h):
        raise ValueError(f"{op}: dtx {tuple(dtx.shape)} / cums "
                         f"{tuple(cums.shape)} do not fit C "
                         f"{tuple(C.shape)}")
    if not (1 <= n <= MAX_STATE and 1 <= p <= MAX_HEAD_DIM
            and 1 <= q <= MAX_CHUNK):
        raise ValueError(f"{op}: state {n} / head dim {p} / "
                         f"chunk {q} outside 1..{MAX_STATE} / "
                         f"1..{MAX_HEAD_DIM} / 1..{MAX_CHUNK}")
    if "dy" in tensors and (tensors["dy"].shape != dtx.shape or tuple(
            tensors["dS"].shape) != (b, nc, h, n, p)):
        raise ValueError(f"{op}: dy {tuple(tensors['dy'].shape)} / dS "
                         f"{tuple(tensors['dS'].shape)} are not dtx's shape "
                         f"/ {(b, nc, h, n, p)}")
    if not all(x.is_cuda for x in tensors.values()):
        raise ValueError(f"{op} needs CUDA tensors; the plain version is "
                         f"ref.{op.replace('_cuda', '_ref')}")
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{op}: {name} has dtype {x.dtype}, "
                             "expected float32")
        if x.device != C.device:
            raise ValueError(f"{op}: {name} is on {x.device}, "
                             f"expected {C.device}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if C.numel() == 0 or dtx.numel() == 0:
        raise ValueError(f"{op}: empty input")
    return b, nc, q, n, h, p


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
    b, nc, q, n, h, p = _check("ssd_intra_cuda", {"C": C, "B": B, "dtx": dtx,
                                                  "cums": cums})
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


def ssd_intra_bwd_cuda(C: torch.Tensor, B: torch.Tensor, dtx: torch.Tensor,
                       cums: torch.Tensor, dy: torch.Tensor,
                       dS: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The intra-chunk form's backward on the card: `ssd_intra_cuda`'s
    inputs and the cotangents dy (b,nc,Q,H,P) and dS (b,nc,H,N,P) of its
    outputs, all contiguous f32 CUDA tensors under the same limits.
    Returns (dC, dB (b,nc,Q,N), ddtx (b,nc,Q,H,P), dcums (b,nc,Q,H)), f32.
    One call launches the kernel's three functions and counts once.
    Raises on anything the kernel does not take, and under grad mode when
    an input requires grad; never falls back to the plain version."""
    require_no_grad("ssd_intra_bwd_cuda", K3_BACKWARD, C, B, dtx, cums, dy,
                    dS)
    b, nc, q, n, h, p = _check("ssd_intra_bwd_cuda", {
        "C": C, "B": B, "dtx": dtx, "cums": cums, "dy": dy, "dS": dS})
    lib = _bwd_library()
    dC, dB = torch.empty_like(C), torch.empty_like(B)
    ddtx, dcums = torch.empty_like(dtx), torch.empty_like(cums)
    scratch = torch.empty(lib.ssd_intra_bwd_scratch_floats(b * nc, q, h),
                          dtype=torch.float32, device=C.device)
    with torch.cuda.device(C.device):
        err = lib.ssd_intra_bwd_launch(
            C.data_ptr(), B.data_ptr(), dtx.data_ptr(), cums.data_ptr(),
            dy.data_ptr(), dS.data_ptr(), dC.data_ptr(), dB.data_ptr(),
            ddtx.data_ptr(), dcums.data_ptr(), scratch.data_ptr(), b * nc,
            q, n, h, p, torch.cuda.current_stream(C.device).cuda_stream)
    if err:
        raise RuntimeError(
            "ssd_intra_bwd kernel launch failed: "
            f"{lib.ssd_intra_bwd_error_string(err).decode()} ({err})")
    ssd_intra_bwd_cuda.launches += 1
    return dC, dB, ddtx, dcums


ssd_intra_bwd_cuda.launches = 0      # kernel launches since the last reset


def ssd_cuda(x, dt, Bm, Cm, A_log, D, chunk: int = 64, h0=None):
    """Full SSD with the CUDA intra-chunk kernel (same contract as
    `ref.ssd_ref`). Raises under grad mode when an input requires grad."""
    require_no_grad("ssd_cuda", K3_BACKWARD, x, dt, Bm, Cm, A_log, D, h0)
    return ssd_with_intra(ssd_intra_cuda, x, dt, Bm, Cm, A_log, D,
                          chunk=chunk, h0=h0)
