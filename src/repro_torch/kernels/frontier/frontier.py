"""The hand-written CUDA frontier-relax kernel: binding, launch plan and
wrapper.

`csrc/frontier_relax.cu` is the Hopper counterpart of the Pallas TPU
kernel `repro.kernels.frontier.frontier.frontier_relax_pallas`; its
header says what bounds it and how the design answers that. The kernel
is compiled at first use by `repro_torch.kernels._build` (nvcc, sm_90a,
a plain C interface loaded with `ctypes`, keyed on the source's hash, in
`build/` beside this file) and launched on PyTorch's current stream.
Nothing is compiled when the module is imported. The plain PyTorch
version of the same step is `ops.frontier_relax_torch`; `activity_mask`
is the plain twin of the kernel's activity pre-pass, and `launch_plan`
the ring depth, stage size, split and grid the wrapper launches with.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "frontier_relax.cu"
SEMIRING_IDS = {"min_plus": 0, "max_min": 1, "or_and": 2, "plus_times": 3}
MAX_SMEM = 232_448          # bytes of shared memory one block may use
SM_SHARED = 233_472         # shared memory of one SM
CTA_RESERVED = 1_024        # of it, what the card keeps for each block
SMS = 132                   # the H100 SXM's SMs (the plan's default)
QUERY_CHUNK = 8             # queries per work item (QB in the source)
FEATURE_SLAB = 8            # features per work item at d > 1 (FD)
STAGE_BYTES = 32_768        # weight bytes a ring stage aims at
MAX_STAGES = 8
MAX_CONSUMERS = 512         # consumer threads of a block (+ 32 producer)
MAX_CONSUMERS_FEATURES = 256    # the same at d > 1 (64 accumulators each)
DEEP_BLOCKS = 32            # mean blocks a destination tile from which a
                            # block takes a whole SM and segments split
MIN_PART_BLOCKS = 32        # blocks a part of a split segment holds
ITEMS_PER_BLOCK = 8         # work items the split aims at per block


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch of K1 is laid out (`launch_plan`)."""
    lanes: int          # destination lanes a consumer thread owns (LPT)
    feature_slab: int   # features a work item holds (FD)
    consumers: int      # consumer threads; one producer warp on top
    groups: int         # row groups that split a stage's rows
    rows: int           # weight rows a ring stage holds
    stages: int         # ring depth
    split: int          # parts a destination tile's segment is cut into
    blocks_per_sm: int  # thread blocks the plan fits on one SM
    items: int          # work items: tiles x split x query/feature chunks
    grid: int           # persistent thread blocks
    smem: int           # dynamic shared memory of one thread block

    def as_args(self):
        """The six ints `frontier_relax_launch` reads."""
        return (ctypes.c_int * 6)(self.rows, self.stages, self.split,
                                  self.consumers, self.grid, self.smem)


def layout_bytes(tile: int, feature_slab: int, lanes: int, consumers: int,
                 rows: int, stages: int) -> int:
    """Dynamic shared memory of one thread block, as the source lays it
    out: the ring's stages (weight rows, then the matching source rows as
    [row][QB][FD]), the row groups' combine buffer, a full and an empty
    mbarrier and a header per stage, and a flag."""
    stage = 4 * rows * tile + 4 * rows * QUERY_CHUNK * feature_slab
    groups = consumers // (tile // lanes)
    comb = 4 * consumers * lanes * QUERY_CHUNK * feature_slab \
        if groups > 1 else 0
    return stages * stage + comb + stages * (8 + 8 + 16) + 16


def part_bounds(lo: int, hi: int, part: int, split: int) -> tuple[int, int]:
    """The blocks [lo', hi') that part `part` of a segment [lo, hi) cut
    into `split` parts relaxes, as the source cuts it."""
    n = hi - lo
    return lo + n * part // split, lo + n * (part + 1) // split


@functools.lru_cache(maxsize=256)
def launch_plan(tile: int, feature_dim: int, batch: int, nb: int,
                ntiles: int, sms: int = SMS) -> LaunchPlan:
    """The launch of K1 for T = `tile`, feature width d, B queries, `nb`
    blocks over `ntiles` destination tiles, on a card of `sms` SMs.

    Deep segments (a mean of DEEP_BLOCKS blocks or more a destination
    tile, as on a Kronecker graph) take one block an SM with as many
    32 KiB stages as fit, and are split into parts of MIN_PART_BLOCKS
    blocks or more, so that ITEMS_PER_BLOCK work items a block balance
    the grid. Short segments (a road network's) stay whole and take
    several blocks an SM, each with its own producer and a ring of 16 KiB
    stages: two of 256 consumer threads, or, for at most half a chunk of
    queries, four of 128, whose producers walk more segments at once.
    Raises ValueError for a tile the kernel does not take."""
    if tile % 4 or tile <= 0:
        raise ValueError(f"frontier_relax_cuda: tile {tile} is not a "
                         "multiple of 4 (the bulk copies move 16 bytes)")
    fd = 1 if feature_dim <= 1 else FEATURE_SLAB
    lanes = 4 if fd == 1 else 1
    mean = nb / max(1, ntiles)
    deep = mean >= DEEP_BLOCKS
    few = batch <= QUERY_CHUNK // 2
    per_sm = 1 if deep else 4 if few and fd == 1 else 2
    consumers = 128 if fd > 1 or per_sm == 4 else 256
    consumers = -(-max(consumers, tile // lanes) // 32) * 32
    most = MAX_CONSUMERS if fd == 1 else MAX_CONSUMERS_FEATURES
    if consumers > most:
        raise ValueError(f"frontier_relax_cuda: tile {tile} at feature_dim "
                         f"{feature_dim} exceeds one thread block "
                         f"({consumers} > {most} consumer threads)")
    groups = consumers // (tile // lanes)
    rows = min(tile, max(1, STAGE_BYTES // min(per_sm, 2) // (4 * tile)))
    budget = min(MAX_SMEM, SM_SHARED // per_sm - CTA_RESERVED)
    fixed = layout_bytes(tile, fd, lanes, consumers, rows, 0)
    per_stage = layout_bytes(tile, fd, lanes, consumers, rows, 1) - fixed
    stages = min(MAX_STAGES, (budget - fixed) // per_stage)
    if stages < 2:
        raise ValueError(f"frontier_relax_cuda: tile {tile} at feature_dim "
                         f"{feature_dim} exceeds one thread block "
                         f"(two stages need {fixed + 2 * per_stage} B > "
                         f"{budget} B of shared memory)")
    chunks = -(-batch // QUERY_CHUNK) * -(-max(1, feature_dim) // fd)
    split = 1
    if deep:
        want = -(-ITEMS_PER_BLOCK * sms * per_sm // (ntiles * chunks))
        split = max(1, min(want, int(mean) // MIN_PART_BLOCKS))
    items = ntiles * split * chunks
    grid = max(1, min(items, sms * per_sm))
    return LaunchPlan(lanes=lanes, feature_slab=fd, consumers=consumers,
                      groups=groups, rows=rows, stages=stages, split=split,
                      blocks_per_sm=per_sm, items=items, grid=grid,
                      smem=layout_bytes(tile, fd, lanes, consumers, rows,
                                        stages))


def scratch_bytes(plan: LaunchPlan, batch: int, nsrc: int, ntiles: int,
                  tile: int, feature_dim: int) -> int:
    """Bytes of the scratch the wrapper hands the kernel, laid out as the
    source reads it: the transposed source values, the activity mask,
    the work counters, and (split > 1) the parts, each 16-byte aligned."""
    fd = plan.feature_slab
    chunks = -(-batch // QUERY_CHUNK) * -(-max(1, feature_dim) // fd)
    up = lambda n: -(-n // 16) * 16                      # noqa: E731
    svt = 4 * chunks * nsrc * tile * QUERY_CHUNK * fd
    mask = 4 * chunks * nsrc
    counters = 4 * (1 + ntiles * chunks)
    parts = 4 * plan.items * QUERY_CHUNK * tile * fd if plan.split > 1 else 0
    return up(svt) + up(mask) + up(counters) + up(parts)


def activity_mask(src_vals: torch.Tensor, semiring,
                  feature_dim: int = 1) -> torch.Tensor:
    """The plain twin of the kernel's activity pre-pass: for (B?, nsrc,
    T[, d]) source values, (chunks, nsrc) int32 words, chunk = (query
    chunk, feature slab) of QUERY_CHUNK queries x FEATURE_SLAB features,
    bit q set when query q of the chunk holds a lane != the ⊕-identity
    on the tile within the slab's features (NaN counts as active)."""
    features = feature_dim > 1
    x = src_vals if src_vals.ndim == 3 + features else src_vals[None]
    if not features:
        x = x[..., None]
    b, nsrc, t, d = x.shape
    fd = FEATURE_SLAB if features else 1
    nqc, nfc = -(-b // QUERY_CHUNK), -(-d // fd)
    act = (x != semiring.zero)
    act = torch.nn.functional.pad(act, (0, nfc * fd - d, 0, 0, 0, 0,
                                        0, nqc * QUERY_CHUNK - b))
    act = act.reshape(nqc, QUERY_CHUNK, nsrc, t, nfc, fd).any(dim=5) \
        .any(dim=3)                                # (nqc, QB, nsrc, nfc)
    bits = (act.to(torch.int32)
            << torch.arange(QUERY_CHUNK, dtype=torch.int32).view(1, -1, 1, 1))
    words = bits.sum(dim=1, dtype=torch.int32)     # (nqc, nsrc, nfc)
    return words.permute(0, 2, 1).reshape(nqc * nfc, nsrc)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.frontier_relax_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
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
    query are skipped inside the kernel (exact). Two kernels run on the
    current stream: the activity pre-pass, then the relaxation laid out
    by `launch_plan`; the scratch they share is allocated here. Raises
    on anything the kernel does not take (a tile that is not a multiple
    of 4, too wide a tile, unaligned blocks); never falls back to the
    plain version.
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
    plan = launch_plan(t, feature_dim, b, blocks.shape[0], ntiles,
                       _sm_count(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    if blocks.numel() and blocks.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("frontier_relax_cuda: blocks and carry must start "
                         "on a 16-byte boundary (the bulk copies and the "
                         "16-byte carry loads need it)")
    out = torch.empty_like(cv)
    scratch = torch.empty(
        scratch_bytes(plan, b, nsrc, ntiles, t, feature_dim),
        dtype=torch.uint8, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.frontier_relax_launch(
            sv.data_ptr(), cv.data_ptr(), blocks.data_ptr(),
            bsrc.data_ptr(), dst_start.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, nsrc, ntiles, t, max(1, feature_dim),
            SEMIRING_IDS[semiring.name], plan.as_args(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            "frontier_relax kernel launch failed: "
            f"{lib.frontier_relax_error_string(err).decode()} ({err})")
    frontier_relax_cuda.launches += 1
    return out[0] if squeeze else out


frontier_relax_cuda.launches = 0     # kernel launches since the last reset
