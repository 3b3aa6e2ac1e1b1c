"""The hand-written CUDA flash-attention kernels: binding and wrapper.

Three kernels compute the Pallas TPU kernel
`repro.kernels.attention.flash.flash_attention_pallas`, one route each;
`route` picks it from the dtype and head dim, in one place:

* ``"tf32x3"``: `csrc/flash_attention_tf32.cu`, f32 at every hd, on the
  tensor cores: each product as three TF32 products (every operand split
  hi + lo, f32 accumulation; one TF32 product would miss the f32 hold),
  mma.sync m16n8k8; at hd 256 two warp halves split the output's hd;
* ``"wgmma"``: `csrc/flash_attention_wgmma.cu`, bf16 at hd 64/80/128/256,
  on the tensor cores (wgmma, TMA-fed K/V, a producer warpgroup); hd 80
  runs in the hd-128 tile (`wgmma_tile`), its columns 80-127 zero-filled
  by TMA;
* ``"fma"``: `csrc/flash_attention.cu`, bf16 at hd 16/32 (no
  configuration has it), f32 FMAs on the CUDA cores. Its kernel takes f32
  too: `chip_smoke.py` times it against the tf32x3 kernel and holds the
  routes against each other by patching `route`.

The backward, `flash_attention_bwd_cuda`, has the same three routes;
`bwd_route` picks it, in one place:

* ``"tf32x3"``: `csrc/flash_attention_bwd_tf32.cu`, f32 at every hd, 3xTF32
  on the tensor cores (`bwd_dot` for rowsum(dout * out), then `bwd_dkdv`
  and `bwd_dq`, every product mma.sync; at hd 256 dkdv's eight warps split
  hd in two halves; tiles `bwd_tiles`);
* ``"wgmma"``: `csrc/flash_attention_bwd_wgmma.cu`, bf16 at hd
  64/80/128/256, on the tensor cores (`bwd_dot`, then `bwd_dkdv` and
  `bwd_dq`, every product a wgmma fed by TMA; hd 80 in the hd-128 tile;
  hd 256 in 64-row tiles whose hd its two consumer warpgroups split);
* ``"fma"``: `csrc/flash_attention_bwd.cu`, bf16 at hd 16/32 (and f32 when
  patched in), f32 FMAs on the CUDA cores (`bwd_prep` recomputes L and D,
  then `bwd_dkdv`, `bwd_dq`).

The "tf32x3" and "wgmma" backwards take the row log-sum-exp L that their
forwards write when asked (`flash_attention_cuda(..., return_lse=True)`)
and raise without it (`LSE_ROUTES`). `ops.FlashAttention` joins each
backward to the forward under autograd, asking the forward for L when the
backward's route takes it.

Each source's header says what bounds it and how the design answers that.
They are built at first use by `repro_torch.kernels._build` and launched
on PyTorch's current stream. There is no fallback from one route to
another: a failed build or launch raises. The plain PyTorch versions of
the same functions are `ref.attention_ref`, `ref.attention_lse_ref` and
`ref.attention_bwd_ref`. The raw wrappers raise under grad mode when an
input requires grad (`kernels._grad.require_no_grad`): their outputs carry
no gradient.
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
TF32_SOURCE = CSRC / "flash_attention_tf32.cu"      # the "tf32x3" route
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"        # the "fma" backward
BWD_WGMMA_SOURCE = CSRC / "flash_attention_bwd_wgmma.cu"   # "wgmma" backward
BWD_TF32_SOURCE = CSRC / "flash_attention_bwd_tf32.cu"     # "tf32x3" backward
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
BWD_WGMMA_HEAD_DIMS = (64, 80, 128, 256)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
# route -> (source, prefix of its C functions `<prefix>_launch` and
# `<prefix>_error_string`, which share one signature)
ROUTES = {"tf32x3": (TF32_SOURCE, "flash_attention_tf32"),
          "wgmma": (WGMMA_SOURCE, "flash_attention_wgmma"),
          "fma": (SOURCE, "flash_attention")}
# the backward's routes, the same way ("tf32x3" and "wgmma" share one
# signature, "fma" has its own)
BWD_ROUTES = {"tf32x3": (BWD_TF32_SOURCE, "flash_attention_bwd_tf32"),
              "wgmma": (BWD_WGMMA_SOURCE, "flash_attention_bwd_wgmma"),
              "fma": (BWD_SOURCE, "flash_attention_bwd")}
# the routes whose forward writes L on request and whose backward takes it
LSE_ROUTES = ("tf32x3", "wgmma")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that q/k/v of `dtype` and `head_dim` take: ``"tf32x3"``
    for f32 at any hd in `HEAD_DIMS`, ``"wgmma"`` for bf16 at hd
    64/80/128/256, ``"fma"`` for bf16 at hd 16/32. Raises on anything
    else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {head_dim} not "
                         f"in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "tf32x3"
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "fma"
    raise ValueError(f"flash_attention_cuda: dtype {dtype}; the kernels "
                     "take float32 or bfloat16")


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel that q/k/v of `dtype` and `head_dim` take: the
    forward's route name (`BWD_WGMMA_HEAD_DIMS` = `WGMMA_HEAD_DIMS`):
    ``"tf32x3"`` for f32 at any hd in `HEAD_DIMS`, ``"wgmma"`` for bf16 at
    hd 64/80/128/256 (both need the forward's L), ``"fma"`` for bf16 at
    hd 16/32. Raises on anything else."""
    return route(dtype, head_dim)


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


def bwd_tiles(head_dim: int, route_name: str
              ) -> tuple[tuple[int, int], tuple[int, int]]:
    """The backward kernels' tiles on `route_name` at `head_dim`, as
    ``((q rows, kv rows) of the dkdv walk, (q rows, kv rows) of the dq
    walk)``. "wgmma": dkdv owns 128 kv rows and steps 64 q rows, dq owns
    128 q rows and steps 64 kv rows; at hd 256 each owns 64 rows (its two
    consumer warpgroups split hd, not rows: registers and shared memory).
    "tf32x3": dkdv owns 64 kv rows and steps 32 q rows (at hd 256 its
    eight warps split hd), dq owns 64 q rows and steps 32 kv rows, 16 at
    hd 256 (registers). "fma": 64 q rows and 64 kv rows in both, 32 kv
    rows at hd 256 (shared memory)."""
    if route_name == "tf32x3":
        return (32, 64), (64, 16 if head_dim > 128 else 32)
    if route_name == "wgmma":
        return ((64, 64), (64, 64)) if head_dim > 128 else ((64, 128),
                                                            (128, 64))
    tiles = (64, 32 if head_dim > 128 else 64)
    return tiles, tiles


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
    # q, k, v, out, lse (null: not written); dtype, B, S, T, H, KH, hd,
    # causal, window; scale; stream
    launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return launch, error


def _launch(route_name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool, window: int | None,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the named route's kernel on checked inputs, writing
    the row log-sum-exp into `lse` when it is given; counts nothing.
    `flash_attention_cuda` is the wrapper."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launch, error = _library(route_name)
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
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
                         causal: bool = True, window: int | None = None,
                         return_lse: bool = False):
    """GQA attention on the card. q: (B,S,H,hd); k/v: (B,T,KH,hd), all
    contiguous, 16-byte aligned CUDA tensors of one dtype (f32 or bf16),
    H % KH == 0, hd in `HEAD_DIMS`. Returns (B,S,H,hd) in q's dtype; with
    `return_lse` (the `LSE_ROUTES` only: "tf32x3", "wgmma") also the
    (B,H,S) f32 row log-sum-exp of the masked, scaled scores (natural log;
    +inf on a row that sees no key), which the same route's backward takes
    (plain version: `ref.attention_lse_ref`). The route is
    `route(q.dtype, hd)`. Raises on anything the kernels do not take, and
    under grad mode when an input requires grad (use
    `ops.flash_attention`); never falls back to the plain version or
    another route."""
    require_no_grad("flash_attention_cuda",
                    "differentiate through ops.flash_attention", q, k, v)
    name = _check(q, k, v, window)
    lse = None
    if return_lse:
        if name not in LSE_ROUTES:
            raise ValueError("flash_attention_cuda: return_lse needs a "
                             f"route of {LSE_ROUTES}; {q.dtype} at hd "
                             f"{q.shape[3]} takes {name!r}")
        b, s, h = q.shape[:3]
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = _launch(name, q, k, v, causal, window, lse)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[name] += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0    # kernel launches since the last reset
flash_attention_cuda.route_launches = dict.fromkeys(ROUTES, 0)  # by route


@functools.cache
def _bwd_library(route_name: str):
    """The backward route's built ``(launch, error_string)`` C functions."""
    source, prefix = BWD_ROUTES[route_name]
    lib = _build.load(source)
    launch = getattr(lib, f"{prefix}_launch")
    error = getattr(lib, f"{prefix}_error_string")
    if route_name in LSE_ROUTES:
        # q, k, v, o, do, lse, dq, dk, dv, D; B, S, T, H, KH, hd, causal,
        # window; scale; stream
        launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
    else:
        # q, k, v, o, do, dq, dk, dv, L, D; dtype, B, S, T, H, KH, hd,
        # causal, window; scale; stream
        launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return launch, error


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: int | None = None,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of `flash_attention_cuda(q, k, v, causal, window)` = o
    for the output gradient `do`, on the card: (dq, dk, dv) in the inputs'
    dtype, accumulated in f32, dk/dv summed over each kv head's group of
    query heads. q, k, v as `flash_attention_cuda` takes them; o and do of
    q's shape, dtype and device, contiguous and 16-byte aligned. The route
    is `bwd_route(q.dtype, hd)`: "tf32x3" and "wgmma" take `lse`, the
    forward's (B,H,S) f32 row log-sum-exp (`flash_attention_cuda(...,
    return_lse=True)`) and raise without it; "fma" recomputes it and takes
    none. One call launches the route's three functions and counts once.
    Raises on anything the kernels do not take, and under grad mode when
    an input requires grad (double backward is not supported); never falls
    back to the plain version or another route."""
    require_no_grad("flash_attention_bwd_cuda",
                    "double backward is not supported", q, k, v, o, do)
    name = bwd_route(q.dtype, q.shape[-1])
    if name in LSE_ROUTES and lse is None:
        raise ValueError(f"flash_attention_bwd_cuda: the {name} backward "
                         "takes the forward's row log-sum-exp: pass lse "
                         "from flash_attention_cuda(..., return_lse=True)")
    if name == "fma" and lse is not None:
        raise ValueError("flash_attention_bwd_cuda: the fma backward "
                         "recomputes L; pass lse=None")
    _check(q, k, v, window, "flash_attention_bwd_cuda")
    for label, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {label} "
                             f"{tuple(x.shape)} {x.dtype} on {x.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_cuda: {label} must be "
                             "contiguous and 16-byte aligned")
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (b, h, s)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd_cuda: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}; want a contiguous "
                         f"({b}, {h}, {s}) float32 tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch, error = _bwd_library(name)
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if name in LSE_ROUTES:
            delta = torch.empty((b, h, s), dtype=torch.float32,
                                device=q.device)
            err = launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), b, s, t, h, kh, hd,
                int(causal), 0 if window is None else int(window), scale,
                stream)
        else:
            scratch = torch.empty((2, b, h, s), dtype=torch.float32,
                                  device=q.device)
            err = launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(),
                DTYPE_IDS[q.dtype], b, s, t, h, kh, hd, int(causal),
                0 if window is None else int(window), scale, stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd ({name}) kernel launch "
                           f"failed: {error(err).decode()} ({err})")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.route_launches[name] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0    # calls (3 kernels each) since reset
flash_attention_bwd_cuda.route_launches = dict.fromkeys(BWD_ROUTES, 0)
