"""The hand-written CUDA frontier-relax kernel: build, binding, wrapper.

`csrc/frontier_relax.cu` is the Hopper counterpart of the Pallas TPU
kernel `repro.kernels.frontier.frontier.frontier_relax_pallas`; its
header says what bounds it and how the design answers that. This module
compiles it with `nvcc` for `sm_90a` into a shared library with a plain
C interface at first use, keyed on a hash of the source and the flags,
loads it with `ctypes`, and launches it on PyTorch's current stream.

The build lives in `build/` beside this file (listed in `.gitignore`),
so a fresh checkout builds itself; nothing is compiled when the module is
imported. The plain PyTorch version of the same step is
`ops.frontier_relax_torch`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier_relax.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# no --use_fast_math: flush-to-zero and approximate ops would break the
# bit-equality of the min/max semirings with the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SEMIRING_IDS = {"min_plus": 0, "max_min": 1, "or_and": 2, "plus_times": 3}
MAX_SMEM = 232_448          # bytes of shared memory one block may use
QUERY_CHUNK = 8             # queries per thread block (QB in the source)
FEATURE_SLAB = 8            # features per thread block at d > 1 (FD)


def nvcc() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the toolkit named by
    CUDA_HOME / CUDA_PATH, else the toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "frontier_relax: no nvcc found (PATH, CUDA_HOME, CUDA_PATH); the "
        "CUDA kernel is built from source at first use")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"frontier_relax-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernel unless this source's library exists already.
    Returns ``(path, seconds, compiler log)``; `verbose` adds
    ``-Xptxas -v`` (registers, shared memory, spills per kernel) to the
    log without changing the library."""
    path = library_path()
    if path.exists() and not verbose:
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.frontier_relax_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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

    src_vals/carry: (B?, ntiles, T[, d]) f32 CUDA tensors (a leading
    query axis is optional; d only when `feature_dim` > 1). blocks:
    (nb, T, T) f32 sorted by (bdst, bsrc); bsrc: (nb,) i32;
    dst_start: (ntiles + 1,) i32 segment starts per destination tile.
    Blocks whose source tile is all ⊕-identity for a query are skipped
    inside the kernel (exact). Raises on anything the kernel does not
    take; never falls back to the plain version.
    """
    if not src_vals.is_cuda:
        raise ValueError("frontier_relax_cuda needs CUDA tensors; the "
                         "plain version is ops.frontier_relax_torch")
    if semiring.name not in SEMIRING_IDS:
        raise ValueError(f"frontier_relax_cuda: no kernel for semiring "
                         f"{semiring.name!r}")
    features = feature_dim > 1
    if src_vals.shape != carry.shape:
        raise ValueError(f"src_vals {tuple(src_vals.shape)} / carry "
                         f"{tuple(carry.shape)} state shapes disagree")
    if src_vals.ndim not in (2 + features, 3 + features):
        raise ValueError(f"frontier_relax_cuda: state rank {src_vals.ndim} "
                         f"does not fit feature_dim {feature_dim}")
    if features and src_vals.shape[-1] != feature_dim:
        raise ValueError(f"state carries feature_dim {src_vals.shape[-1]} "
                         f"but the kernel was asked for {feature_dim}")
    squeeze = src_vals.ndim == 2 + features
    sv, cv = (src_vals[None], carry[None]) if squeeze else (src_vals, carry)
    b, ntiles, t = sv.shape[:3]
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
                         f"match {ntiles} tiles")
    fd = FEATURE_SLAB if features else 1
    smem = QUERY_CHUNK * t * fd * 4
    if t > 1024 or smem > MAX_SMEM:
        raise ValueError(f"frontier_relax_cuda: tile {t} at feature_dim "
                         f"{feature_dim} exceeds one thread block "
                         f"(T <= 1024 threads, {smem} B > {MAX_SMEM} B of "
                         "shared memory)")
    out = torch.empty_like(sv)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.frontier_relax_launch(
            sv.data_ptr(), cv.data_ptr(), blocks.data_ptr(),
            bsrc.data_ptr(), dst_start.data_ptr(), out.data_ptr(),
            b, ntiles, t, max(1, feature_dim),
            SEMIRING_IDS[semiring.name],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            "frontier_relax kernel launch failed: "
            f"{lib.frontier_relax_error_string(err).decode()} ({err})")
    frontier_relax_cuda.launches += 1
    return out[0] if squeeze else out


frontier_relax_cuda.launches = 0     # kernel launches since the last reset
