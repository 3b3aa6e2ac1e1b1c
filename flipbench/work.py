"""The yardstick's arithmetic: the card's peaks, and the bytes and
operations that one relax step of K1 needs on given inputs.

The layout is worked out here from the raw edge list, at a fixed tile
size in vertex-id order (the port's default plan), so the count reads the
same work whatever implements K1: the blocks of T x T f32 that hold an
edge (u -> v) between source tile u // T and destination tile v // T,
plus one diagonal block per destination tile. A step needs every block
whose source tile holds a frontier vertex of some query of the batch
(the reference's "blocks fetched"), read once, plus the state: source
values and carry read once, the output written once, and the block
index arrays read once. Operations: 2 (⊗ and ⊕) per (query, block,
source lane, destination lane) for the blocks that query's own frontier
needs.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TILE = 128                     # the yardstick's tile (the port's default)


def blocks_per_source_tile(raw, tile: int = TILE) -> np.ndarray:
    """(ntiles,) int64: how many blocks each source tile feeds."""
    ntiles = -(-raw.n // tile)
    u = raw.sources()
    v = raw.indices.astype(np.int64)
    key = np.unique(np.concatenate([(v // tile) * ntiles + u // tile,
                                    np.arange(ntiles) * (ntiles + 1)]))
    return np.bincount(key % ntiles, minlength=ntiles).astype(np.int64)


def step_work(tiles: np.ndarray, per_tile: np.ndarray,
              tile: int = TILE) -> tuple[int, int, int]:
    """Bytes, operations and blocks of the steps in `tiles` ((steps, B,
    ntiles) bool: each query's frontier tiles entering each step)."""
    tiles = np.asarray(tiles, dtype=bool)
    steps, b, ntiles = tiles.shape
    union = tiles.any(axis=1)                            # (steps, ntiles)
    blocks = int((union * per_tile).sum())
    pairs = int((tiles * per_tile).sum())                # (query, block)
    state = b * ntiles * tile * 4
    index = (int(per_tile.sum()) + ntiles + 1) * 4
    nbytes = blocks * tile * tile * 4 + steps * (3 * state + index)
    ops = pairs * tile * tile * 2
    return nbytes, ops, blocks


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
