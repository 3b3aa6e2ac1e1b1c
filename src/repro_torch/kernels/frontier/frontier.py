"""The hand-written CUDA frontier-relax kernel: binding and wrapper.

`csrc/frontier_relax.cu` is the Hopper counterpart of the Pallas TPU
kernel `repro.kernels.frontier.frontier.frontier_relax_pallas`; its
header says what bounds it and how the design answers that. The kernel
is compiled at first use by `repro_torch.kernels._build` (nvcc, sm_90a,
a plain C interface loaded with `ctypes`, keyed on the source's hash, in
`build/` beside this file) and launched on PyTorch's current stream.
Nothing is compiled when the module is imported. The plain PyTorch
version of the same step is `ops.frontier_relax_torch`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier_relax.cu"
SEMIRING_IDS = {"min_plus": 0, "max_min": 1, "or_and": 2, "plus_times": 3}
MAX_SMEM = 232_448          # bytes of shared memory one block may use
QUERY_CHUNK = 8             # queries per thread block (QB in the source)
FEATURE_SLAB = 8            # features per thread block at d > 1 (FD)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.frontier_relax_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.frontier_relax_launch.restype = ctypes.c_int
    lib.frontier_relax_error_string.argtypes = [ctypes.c_int]
    lib.frontier_relax_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"frontier_relax_cuda: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"frontier_relax_cuda: {name} has dtype "
                         f"{x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"frontier_relax_cuda: {name} is not contiguous")


def frontier_relax_cuda(src_vals: torch.Tensor, carry: torch.Tensor,
                        blocks: torch.Tensor, bsrc: torch.Tensor,
                        dst_start: torch.Tensor, semiring,
                        feature_dim: int = 1) -> torch.Tensor:
    """One relaxation step on the card:
    ``out[b, t] = carry[b, t] ⊕ ⊕_{i in dst_start[t]:dst_start[t+1]}
    src_vals[b, bsrc[i]] ⊗ blocks[i]``.

    src_vals: (B?, nsrc, T[, d]) and carry: (B?, ntiles, T[, d]) f32 CUDA
    tensors (a leading query axis is optional; d only when `feature_dim`
    > 1). nsrc = ntiles for a whole layout; a rank of the distributed
    fixpoint passes the replicated state of every tile and the carry of
    its own slab of destination tiles. blocks: (nb, T, T) f32 sorted by
    (bdst, bsrc); bsrc: (nb,) i32 source tiles in [0, nsrc); dst_start:
    (ntiles + 1,) i32 segment starts per destination tile. The output
    has carry's shape. Blocks whose source tile is all ⊕-identity for a
    query are skipped inside the kernel (exact). Raises on anything the
    kernel does not take; never falls back to the plain version.
    """
    if not src_vals.is_cuda:
        raise ValueError("frontier_relax_cuda needs CUDA tensors; the "
                         "plain version is ops.frontier_relax_torch")
    if semiring.name not in SEMIRING_IDS:
        raise ValueError(f"frontier_relax_cuda: no kernel for semiring "
                         f"{semiring.name!r}")
    features = feature_dim > 1
    if src_vals.ndim not in (2 + features, 3 + features):
        raise ValueError(f"frontier_relax_cuda: state rank {src_vals.ndim} "
                         f"does not fit feature_dim {feature_dim}")
    tax = src_vals.ndim - 2 - features             # the tile axis
    if (carry.ndim != src_vals.ndim
            or carry.shape[:tax] != src_vals.shape[:tax]
            or carry.shape[tax + 1:] != src_vals.shape[tax + 1:]):
        raise ValueError(f"src_vals {tuple(src_vals.shape)} / carry "
                         f"{tuple(carry.shape)} state shapes disagree "
                         "outside the tile axis")
    if features and src_vals.shape[-1] != feature_dim:
        raise ValueError(f"state carries feature_dim {src_vals.shape[-1]} "
                         f"but the kernel was asked for {feature_dim}")
    squeeze = tax == 0
    sv, cv = (src_vals[None], carry[None]) if squeeze else (src_vals, carry)
    b, nsrc, t = sv.shape[:3]
    ntiles = cv.shape[1]
    dev = sv.device
    for name, x, dt in (("src_vals", sv, torch.float32),
                        ("carry", cv, torch.float32),
                        ("blocks", blocks, torch.float32),
                        ("bsrc", bsrc, torch.int32),
                        ("dst_start", dst_start, torch.int32)):
        _check(name, x, dt, dev)
    if blocks.ndim != 3 or tuple(blocks.shape[1:]) != (t, t):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match tile "
                         f"{t}")
    if bsrc.shape != (blocks.shape[0],):
        raise ValueError(f"bsrc {tuple(bsrc.shape)} does not match "
                         f"{blocks.shape[0]} blocks")
    if dst_start.shape != (ntiles + 1,):
        raise ValueError(f"dst_start {tuple(dst_start.shape)} does not "
                         f"match {ntiles} destination tiles")
    fd = FEATURE_SLAB if features else 1
    smem = QUERY_CHUNK * t * fd * 4
    if t > 1024 or smem > MAX_SMEM:
        raise ValueError(f"frontier_relax_cuda: tile {t} at feature_dim "
                         f"{feature_dim} exceeds one thread block "
                         f"(T <= 1024 threads, {smem} B > {MAX_SMEM} B of "
                         "shared memory)")
    out = torch.empty_like(cv)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.frontier_relax_launch(
            sv.data_ptr(), cv.data_ptr(), blocks.data_ptr(),
            bsrc.data_ptr(), dst_start.data_ptr(), out.data_ptr(),
            b, nsrc, ntiles, t, max(1, feature_dim),
            SEMIRING_IDS[semiring.name],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            "frontier_relax kernel launch failed: "
            f"{lib.frontier_relax_error_string(err).decode()} ({err})")
    frontier_relax_cuda.launches += 1
    return out[0] if squeeze else out


frontier_relax_cuda.launches = 0     # kernel launches since the last reset
