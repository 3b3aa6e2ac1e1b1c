"""The hand-written CUDA flash-attention kernels: binding and wrapper.

Two kernels compute the Pallas TPU kernel
`repro.kernels.attention.flash.flash_attention_pallas`, one route each;
`route` picks it from the dtype and head dim, in one place:

* ``"wgmma"``: `csrc/flash_attention_wgmma.cu`, bf16 at hd 64/80/128/256,
  on the tensor cores (wgmma, TMA-fed K/V, a producer warpgroup); hd 80
  runs in the hd-128 tile (`wgmma_tile`), its columns 80-127 zero-filled
  by TMA;
* ``"fma"``: `csrc/flash_attention.cu`, f32 at every hd and bf16 at hd
  16/32, f32 FMAs on the CUDA cores (a tensor-core product would not hold
  the f32 cases).

The backward, `flash_attention_bwd_cuda`, is one route for every dtype
and head dim: `csrc/flash_attention_bwd.cu`, f32 FMAs on the CUDA cores
(`bwd_prep` for the row log-sum-exp and rowsum(dout * out), `bwd_dkdv`,
`bwd_dq`); `ops.FlashAttention` joins it to the forward under autograd.

Each source's header says what bounds it and how the design answers that.
They are built at first use by `repro_torch.kernels._build` and launched
on PyTorch's current stream. There is no fallback from one route to the
other: a failed build or launch raises. The plain PyTorch versions of the
same functions are `ref.attention_ref` and `ref.attention_bwd_ref`. The
raw wrappers raise under grad mode when an input requires grad
(`kernels._grad.require_no_grad`): their outputs carry no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import require_no_grad

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"                # the "fma" route
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"    # the "wgmma" route
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"        # the backward
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
# route -> (source, prefix of its C functions `<prefix>_launch` and
# `<prefix>_error_string`, which share one signature)
ROUTES = {"wgmma": (WGMMA_SOURCE, "flash_attention_wgmma"),
          "fma": (SOURCE, "flash_attention")}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that q/k/v of `dtype` and `head_dim` take: ``"wgmma"``
    for bf16 at hd 64/80/128/256, ``"fma"`` for f32 at any hd in
    `HEAD_DIMS` and bf16 at hd 16/32. Raises on anything else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {head_dim} not "
                         f"in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in DTYPE_IDS:
        return "fma"
    raise ValueError(f"flash_attention_cuda: dtype {dtype}; the kernels "
                     "take float32 or bfloat16")


def wgmma_tile(head_dim: int) -> int:
    """The head-dim width of the "wgmma" route's tiles for `head_dim`:
    hd 80 runs in the hd-128 layout (two 64-column boxes, whose columns
    80-127 TMA fills with zeros on load and clips on store); the other
    head dims in their own."""
    return 128 if head_dim == 80 else head_dim


def kv_tile_range(qi: int, bq: int, bkv: int, causal: bool,
                  window: int | None, s: int, t: int) -> tuple[int, int]:
    """The kv tiles ``[first, last]`` that hold a key some row of q tile
    `qi` may see (q rows ``qi*bq .. qi*bq+bq-1`` of `s`, kv rows in tiles
    of `bkv` of `t`). Both CUDA kernels compute the same formula.

    Unlike the reference's ``last = qi * bq // bkv`` (flash.py:36), which
    drops keys when ``bq > bkv``, `last` is the tile of the q tile's last
    row."""
    q0 = qi * bq
    last = -(-t // bkv) - 1
    if causal:
        last = min(last, (min(q0 + bq, s) - 1) // bkv)
    first = 0
    if window is not None:
        first = max(0, (q0 - window + 1) // bkv)
    return first, last


def bwd_tiles(head_dim: int) -> tuple[int, int]:
    """The backward kernel's (q rows, kv rows) per tile at `head_dim`:
    64 q rows; 64 kv rows up to hd 128, 32 at hd 256 (shared memory)."""
    return 64, (32 if head_dim > 128 else 64)


def q_tile_range(kj: int, bq: int, bkv: int, causal: bool,
                 window: int | None, s: int) -> tuple[int, int]:
    """The q tiles ``[first, last]`` (of `s` q rows) whose `kv_tile_range`
    holds kv tile `kj` (empty when ``first > last``): the exact inverse of
    `kv_tile_range` for the same tiles, which the backward kernel's
    `bwd_dkdv` walks (the CUDA source computes the same formula)."""
    k0 = kj * bkv
    nq = -(-s // bq)
    first, last = 0, nq - 1
    if causal:
        first = k0 // bq if k0 < s else nq
    if window is not None:
        last = min(last, (k0 + bkv + window - 2) // bq)
    return first, last


@functools.cache
def _library(route_name: str):
    """The route's built ``(launch, error_string)`` C functions."""
    source, prefix = ROUTES[route_name]
    lib = _build.load(source)
    launch = getattr(lib, f"{prefix}_launch")
    error = getattr(lib, f"{prefix}_error_string")
    launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return launch, error


def _launch(route_name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool, window: int | None
            ) -> torch.Tensor:
    """One launch of the named route's kernel on checked inputs; counts
    nothing. `flash_attention_cuda` is the wrapper."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launch, error = _library(route_name)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_IDS[q.dtype], b, s, t, h, kh, hd, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention ({route_name}) kernel launch "
                           f"failed: {error(err).decode()} ({err})")
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, op: str = "flash_attention_cuda") -> str:
    """Raise on q/k/v that the kernels do not take; return the forward's
    route."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{op} needs CUDA tensors; the "
                         "plain version is ref.attention_ref")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{op}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B,S,H,hd) / (B,T,KH,hd)")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kh == 0 or h % kh:
        raise ValueError(f"{op}: k/v {tuple(k.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{op}: dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; the kernels take one dtype "
                         "for all three")
    name = route(q.dtype, hd)
    if not (q.device == k.device == v.device):
        raise ValueError(f"{op}: q, k, v on different "
                         "devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{op}: q, k, v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{op}: q, k, v must be 16-byte "
                         "aligned")
    if window is not None and window < 1:
        raise ValueError(f"{op}: window {window} < 1")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{op}: empty q or k")
    return name


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None
                         ) -> torch.Tensor:
    """GQA attention on the card. q: (B,S,H,hd); k/v: (B,T,KH,hd), all
    contiguous, 16-byte aligned CUDA tensors of one dtype (f32 or bf16),
    H % KH == 0, hd in `HEAD_DIMS`. Returns (B,S,H,hd) in q's dtype. The
    route is `route(q.dtype, hd)`. Raises on anything the kernels do not
    take, and under grad mode when an input requires grad (use
    `ops.flash_attention`); never falls back to the plain version or the
    other route."""
    require_no_grad("flash_attention_cuda",
                    "differentiate through ops.flash_attention", q, k, v)
    name = _check(q, k, v, window)
    out = _launch(name, q, k, v, causal, window)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[name] += 1
    return out


flash_attention_cuda.launches = 0    # kernel launches since the last reset
flash_attention_cuda.route_launches = {"wgmma": 0, "fma": 0}   # by route


@functools.cache
def _bwd_library():
    """The backward's built ``(launch, error_string)`` C functions."""
    lib = _build.load(BWD_SOURCE)
    launch = lib.flash_attention_bwd_launch
    launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    error = lib.flash_attention_bwd_error_string
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return launch, error


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of `flash_attention_cuda(q, k, v, causal, window)` = o
    for the output gradient `do`, on the card: (dq, dk, dv) in the inputs'
    dtype, accumulated in f32, dk/dv summed over each kv head's group of
    query heads. q, k, v as `flash_attention_cuda` takes them; o and do of
    q's shape, dtype and device, contiguous and 16-byte aligned. One call
    launches the three functions of `csrc/flash_attention_bwd.cu` (prep,
    dkdv, dq) and counts once. Raises on anything the kernel does not take,
    and under grad mode when an input requires grad (double backward is
    not supported); never falls back to the plain version."""
    require_no_grad("flash_attention_bwd_cuda",
                    "double backward is not supported", q, k, v, o, do)
    _check(q, k, v, window, "flash_attention_bwd_cuda")
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} "
                             f"{tuple(x.shape)} {x.dtype} on {x.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be "
                             "contiguous and 16-byte aligned")
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    scratch = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    launch, error = _bwd_library()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), DTYPE_IDS[q.dtype],
            b, s, t, h, kh, hd, int(causal),
            0 if window is None else int(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           f"{error(err).decode()} ({err})")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0    # calls (3 kernels each) since reset
