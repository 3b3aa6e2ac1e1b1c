"""Public ops of the frontier relaxation step.

The port of `repro.kernels.frontier.ops`. `build_blocks` turns a CSR
graph (+ an optional vertex order) into the block-sparse tile form the
kernel consumes, with the reference's numpy build unchanged and the
tensors placed on the session's device. `frontier_relax` dispatches one
step:

  * 'cuda'  -- the hand-written kernel (`frontier.frontier_relax_cuda`)
    on CUDA tensors. It tests the packet-trigger rule per (block, query)
    inside the kernel, so inactive weight blocks never leave HBM: that is
    the compaction, with no pre-pass and no sentinel block. `compact`
    therefore changes nothing on this route.
  * 'torch' -- the plain PyTorch version (`frontier_relax_torch`) on CPU
    tensors, dense or compacted (only blocks with an active source tile
    are gathered). Exact either way.
  * 'auto'  -- 'cuda' for a CUDA tensor, 'torch' for a CPU tensor.

'cuda' on a CPU tensor and 'torch' on a CUDA tensor raise: nothing on
the main path reaches the plain version on the card.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.algebra import Semiring, VertexAlgebra, get_algebra
from repro_torch.graphs.csr import Graph
from repro_torch.kernels.frontier.frontier import frontier_relax_cuda

RELAX_MODES = ("auto", "cuda", "torch")
# bound on the plain version's broadcast intermediate per block chunk:
# eager torch materializes the ⊗ product that XLA fuses away, and
# (B, nb, T, T) f32 is 4 GiB at B = 8 on a 262k-vertex road graph
_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass
class BlockedGraph:
    """Block-sparse tiled adjacency over one algebra's semiring."""
    n: int                      # true vertex count
    tile: int                   # T
    ntiles: int
    blocks: torch.Tensor        # (nb, T, T) f32, ⊕-identity = no edge
    bsrc: torch.Tensor          # (nb,) i32, sorted by (bdst, bsrc)
    bdst: torch.Tensor          # (nb,) i32
    perm: np.ndarray            # original vertex id -> tiled position
    inv_perm: np.ndarray        # tiled position -> original vertex id
    algebra: VertexAlgebra = None
    # (ntiles+1,) i32: the blocks writing destination tile t occupy
    # positions dst_start[t]:dst_start[t+1] -- the segment one CUDA
    # thread block walks
    dst_start: torch.Tensor = None

    def __post_init__(self):
        if self.dst_start is None:
            ds = np.searchsorted(self.bdst.cpu().numpy(),
                                 np.arange(self.ntiles + 1))
            self.dst_start = torch.as_tensor(ds.astype(np.int32),
                                             device=self.blocks.device)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def padded_n(self) -> int:
        return self.ntiles * self.tile

    @property
    def semiring(self) -> Semiring:
        if self.algebra is None:
            raise ValueError("BlockedGraph built without an algebra; "
                             "construct it via build_blocks(graph, algo)")
        return self.algebra.semiring

    def to_tiled(self, attrs_orig: np.ndarray, fill=None,
                 features: bool = False) -> torch.Tensor:
        """(n,) -> (ntiles, T), or batched (B, n) -> (B, ntiles, T), on
        the layout's device; padded lanes hold `fill` (default: the
        ⊕-identity). `features=True` treats the trailing axis as the
        feature width d: (…, n, d) -> (…, ntiles, T, d)."""
        if fill is None:
            fill = np.float32(self.semiring.zero)
        attrs_orig = np.asarray(attrs_orig)
        if features:
            lead, d = attrs_orig.shape[:-2], attrs_orig.shape[-1]
            out = np.full(lead + (self.padded_n, d), fill, dtype=np.float32)
            out[..., self.perm, :] = attrs_orig
            out = out.reshape(lead + (self.ntiles, self.tile, d))
        else:
            lead = attrs_orig.shape[:-1]
            out = np.full(lead + (self.padded_n,), fill, dtype=np.float32)
            out[..., self.perm] = attrs_orig
            out = out.reshape(lead + (self.ntiles, self.tile))
        return torch.from_numpy(out).to(self.device)

    def to_orig(self, attrs_tiled, features: bool = False) -> np.ndarray:
        """(…, ntiles, T) -> (…, n) numpy; with `features=True` the
        trailing feature axis rides along:
        (…, ntiles, T, d) -> (…, n, d)."""
        if isinstance(attrs_tiled, torch.Tensor):
            attrs_tiled = attrs_tiled.cpu().numpy()
        flat = np.asarray(attrs_tiled)
        if features:
            d = flat.shape[-1]
            flat = flat.reshape(flat.shape[:-3] + (-1, d))
            return flat[..., self.perm, :]
        flat = flat.reshape(flat.shape[:-2] + (-1,))
        return flat[..., self.perm]


def _scatter_edges(sr: Semiring, flat: np.ndarray, lin: np.ndarray,
                   w: np.ndarray) -> None:
    """⊕-combine edge values into flattened block storage in place
    (parallel edges merge through the semiring ufunc's `.at`)."""
    if hasattr(sr.add_np, "at"):
        sr.add_np.at(flat, lin, w)
    else:
        for j, x in zip(lin, w):
            flat[j] = sr.add_np(flat[j], x)


def build_blocks(graph: Graph, algo: str | VertexAlgebra = "sssp",
                 tile: int = 128, order: np.ndarray | None = None,
                 device: str | torch.device = "cpu") -> BlockedGraph:
    """Block-sparse semiring adjacency for any registered algebra, on
    `device`. `order[k]` = original id of the vertex at tiled position k
    (default: identity). The numpy build is the reference's: edges from
    the CSR arrays, ⊗ operands from `edge_values`, block ids from one
    `np.unique` over (bdst, bsrc) keys, parallel edges ⊕-combined by the
    semiring ufunc's `.at` scatter."""
    alg = algo if isinstance(algo, VertexAlgebra) else get_algebra(algo)
    sr = alg.semiring
    n = graph.n
    if order is None:
        order = np.arange(n)
    perm = np.empty(n, dtype=np.int64)     # original -> position
    perm[order] = np.arange(n)

    ntiles = max(1, -(-n // tile))
    outdeg = graph.out_degree()
    u = graph.edge_sources()
    v = graph.indices.astype(np.int64)
    w = alg.edge_values(u, v, graph.weights, outdeg)
    if alg.undirected:
        u, v = np.concatenate([u, v]), np.concatenate([v, u])
        w = np.concatenate([w, w])
    pu, pv = perm[u], perm[v]

    # block key = bdst * ntiles + bsrc: np.unique sorts by (bdst, bsrc);
    # the diagonal keys give every destination tile at least one block
    key = (pv // tile) * ntiles + (pu // tile)
    diag = np.arange(ntiles, dtype=np.int64) * (ntiles + 1)
    uniq, inv = np.unique(np.concatenate([key, diag]), return_inverse=True)
    nb = uniq.size
    bdst = (uniq // ntiles).astype(np.int32)
    bsrc = (uniq % ntiles).astype(np.int32)

    blocks = np.full((nb, tile, tile), np.float32(sr.zero), dtype=np.float32)
    lin = (inv[:key.size] * tile + pu % tile) * tile + pv % tile
    _scatter_edges(sr, blocks.reshape(-1), lin, w.astype(np.float32))
    return BlockedGraph(n=n, tile=tile, ntiles=ntiles,
                        blocks=torch.from_numpy(blocks).to(device),
                        bsrc=torch.from_numpy(bsrc).to(device),
                        bdst=torch.from_numpy(bdst).to(device),
                        perm=perm, inv_perm=np.asarray(order),
                        algebra=alg)


def blocked_graph_from_numpy(arrays: Mapping, algebra: VertexAlgebra,
                             device: str | torch.device = "cpu"
                             ) -> BlockedGraph:
    """The port's `BlockedGraph` from another layout's fields as numpy
    arrays (`blocks`, `bsrc`, `bdst`, `perm`, `inv_perm`, `n`, `tile`):
    how identical inputs are carried across from the reference package."""
    n, tile = int(arrays["n"]), int(arrays["tile"])
    return BlockedGraph(
        n=n, tile=tile, ntiles=max(1, -(-n // tile)),
        blocks=torch.from_numpy(np.array(arrays["blocks"], np.float32))
        .to(device),
        bsrc=torch.from_numpy(np.array(arrays["bsrc"], np.int32)).to(device),
        bdst=torch.from_numpy(np.array(arrays["bdst"], np.int32)).to(device),
        perm=np.asarray(arrays["perm"], np.int64),
        inv_perm=np.asarray(arrays["inv_perm"]), algebra=algebra)


def tile_activity(src_vals: torch.Tensor, semiring: Semiring,
                  features: bool = False) -> torch.Tensor:
    """(…, ntiles, T[, d]) source values -> (ntiles,) bool: a tile is
    active iff any lane of any query differs from the ⊕-identity -- the
    kernel's packet-trigger condition."""
    act = src_vals != semiring.zero
    if features:
        act = act.any(dim=-1)
    act = act.any(dim=-1)                          # (…, ntiles)
    return act.reshape(-1, act.shape[-1]).any(dim=0)


def frontier_relax_torch(src_vals: torch.Tensor, carry: torch.Tensor,
                         blocks: torch.Tensor, bsrc: torch.Tensor,
                         bdst: torch.Tensor, semiring: Semiring,
                         feature_dim: int = 1,
                         compact: bool = False) -> torch.Tensor:
    """The plain PyTorch relax step, on any device: per-block
    ⊗-combine, segment-⊕ by `bdst`, merge into `carry`.

    Same shapes as `frontier_relax_cuda` (solo or batched, d = 1 or
    d > 1). `compact` gathers only the blocks whose source tile is
    active for some query (exact: the ⊕-identity annihilates ⊗). Blocks
    go through in chunks so the broadcast ⊗ product stays under
    `_CHUNK_BYTES`.
    """
    features = feature_dim > 1
    tax = carry.ndim - (3 if features else 2)      # the tile axis
    ntiles = carry.shape[tax]
    ids = None
    if compact:
        act = tile_activity(src_vals, semiring, features)
        ids = torch.nonzero(act[bsrc.long()]).flatten()
        bsrc, bdst = bsrc[ids], bdst[ids]
    t = blocks.shape[-1]
    lead = max(1, int(np.prod(carry.shape[:tax])))
    per_block = lead * t * t * (min(feature_dim, 8) if features else 1) * 4
    k = max(1, _CHUNK_BYTES // per_block)
    best = torch.full_like(carry, semiring.zero)
    for c0 in range(0, bsrc.shape[0], k):
        sel = slice(c0, c0 + k)
        sv = src_vals.index_select(tax, bsrc[sel].long())  # (…, k, T[, d])
        w = blocks[ids[sel]] if ids is not None else blocks[sel]
        if features:
            cand = semiring.contract(sv, w)                 # (…, k, T, d)
        else:
            cand = semiring.add_reduce(semiring.mul(sv[..., :, None], w),
                                       dim=-2)              # (…, k, T)
        best = semiring.add(best, semiring.segment_reduce(
            cand, bdst[sel], ntiles, dim=tax))
    return semiring.add(carry, best)


def resolve_relax_mode(mode: str, device: torch.device) -> str:
    """The one 'auto' rule: the kernel on CUDA, the plain version on CPU."""
    if mode not in RELAX_MODES:
        raise ValueError(f"relax mode must be one of {RELAX_MODES}, got "
                         f"{mode!r}")
    if mode == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return mode


def frontier_relax(src_vals: torch.Tensor, carry: torch.Tensor,
                   bg: BlockedGraph, mode: str = "auto",
                   compact: bool = False,
                   feature_dim: int = 1) -> torch.Tensor:
    """One frontier relaxation step over a BlockedGraph.

    src_vals: (B?, ntiles, T[, d]) f32 -- attrs where active, ⊕-identity
              where not; carry: same shape, merged into every
              destination. mode: 'auto' | 'cuda' | 'torch'.
    compact:  plain version only -- relax only blocks with an active
              source tile. The kernel always skips inactive blocks.
    feature_dim: feature width d; must match the state's trailing axis
              when > 1.
    """
    if feature_dim > 1 and src_vals.shape[-1] != feature_dim:
        raise ValueError(
            f"frontier_relax: state trailing axis {src_vals.shape[-1]} "
            f"!= feature_dim {feature_dim} (state shape "
            f"{tuple(src_vals.shape)})")
    mode = resolve_relax_mode(mode, src_vals.device)
    if mode == "cuda":
        if not src_vals.is_cuda:
            raise ValueError(
                "frontier_relax(mode='cuda') needs CUDA tensors, but the "
                f"state is on {src_vals.device}; use mode='torch' (the "
                "plain version) on the CPU")
        return frontier_relax_cuda(src_vals, carry, bg.blocks, bg.bsrc,
                                   bg.dst_start, bg.semiring,
                                   feature_dim=feature_dim)
    if src_vals.is_cuda:
        raise ValueError(
            "frontier_relax(mode='torch') on CUDA tensors: the plain "
            "version serves the CPU only, so the card never runs it on "
            "the main path; use mode='cuda' or 'auto'")
    return frontier_relax_torch(src_vals, carry, bg.blocks, bg.bsrc,
                                bg.bdst, bg.semiring,
                                feature_dim=feature_dim, compact=compact)
