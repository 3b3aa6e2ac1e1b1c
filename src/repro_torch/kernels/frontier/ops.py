"""Public ops of the frontier relaxation step.

The port of `repro.kernels.frontier.ops`. `build_blocks` turns a CSR
graph (+ an optional vertex order) into the block-sparse tile form the
kernel consumes, with the reference's numpy build unchanged and the
tensors placed on the session's device; `BlockedGraph.apply_updates`
re-blocks only the tiles an edge batch touches. `frontier_relax`
dispatches one step:

  * 'cuda'  -- the hand-written kernel (`frontier.frontier_relax_cuda`)
    on CUDA tensors. Its own pre-pass tests the packet-trigger rule once
    per (source tile, query) and the kernel fetches a weight block only
    when some query needs it, so inactive blocks never leave HBM: that
    is the compaction, with no compacted block list and no sentinel
    block. `compact` therefore changes nothing on this route.
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
from repro_torch.device import resolve_device
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
    # positions dst_start[t]:dst_start[t+1] -- the segment one work item
    # of the CUDA kernel walks (or a part of it)
    dst_start: torch.Tensor = None
    version: int = 0            # Graph.version this layout was built from
    graph_fp: str = None        # Graph.fingerprint() of that graph, so
                                # caches can detect stale layouts

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

    # ------------------------------------------------------------------ #
    # streaming mutations: rebuild only the touched tiles
    # ------------------------------------------------------------------ #
    def apply_updates(self, new_graph: Graph,
                      updates) -> tuple["BlockedGraph", "UpdateDelta"]:
        """Incremental re-block against `new_graph` (the post-update
        Graph, ``graph.apply_updates(updates)``), reusing this layout's
        vertex permutation and tiling; the reference's algorithm.

        Only the tile pairs touched by `updates` are rebuilt, on the host
        through the same semiring scatter as `build_blocks`; the old
        values of those cells are gathered from the device by their
        indices alone. When every touched pair keeps a non-empty block
        the update is value-only: the new block tensor is a clone with
        the dirty blocks copied in (this layout stays as it was -- a
        session is an immutable snapshot) and `bsrc`, `bdst`,
        `dst_start` are reused as they are. A batch that fills an empty
        tile pair grows the block list, one that empties an off-diagonal
        block drops it; the keep / insert / reorder then runs on the
        device and `shape_changed` is set. Either way the layout equals
        a from-scratch `build_blocks` of `new_graph`.

        Returns ``(new_bg, delta)``: the warm-start verdict
        (`Semiring.monotone_under` over the changed cells) and the
        source vertices whose out-edge cells changed."""
        alg, sr, t, ntiles = self.algebra, self.semiring, self.tile, \
            self.ntiles
        if new_graph.n != self.n:
            raise ValueError(
                f"apply_updates keeps the vertex set fixed: layout has "
                f"n={self.n}, updated graph has n={new_graph.n}")
        perm = self.perm

        # dirty (u, v) pairs in every stored direction: the graph's own
        # mirroring (undirected CSR) and the algebra's both-half-edges
        # rule (WCC) each add the reverse pair
        uu, vv = [], []
        for upd in updates:
            u, v = int(upd[0]), int(upd[1])
            uu.append(u), vv.append(v)
            if not new_graph.directed or alg.undirected:
                uu.append(v), vv.append(u)
        # degree-dependent ⊗ operands (delta-PageRank): a changed
        # out-degree re-values every surviving out-edge of the source
        if alg.weight_rule == "degree_damped":
            for s in sorted(set(uu)):
                for x in new_graph.neighbors(s):
                    uu.append(s), vv.append(int(x))
        pu = perm[np.asarray(uu, dtype=np.int64)]
        pv = perm[np.asarray(vv, dtype=np.int64)]
        dkeys = np.unique((pv // t) * ntiles + (pu // t))
        fp = new_graph.fingerprint()
        if dkeys.size == 0:                    # empty batch: version-only
            return dataclasses.replace(
                self, version=new_graph.version, graph_fp=fp), UpdateDelta(
                monotone=sr.monotone_under([], []), shape_changed=False,
                affected_src=np.zeros(0, dtype=np.int64),
                n_blocks_rebuilt=0, version=new_graph.version)

        # rebuild the dirty tiles from the new graph's edges
        eu = new_graph.edge_sources()
        ev = new_graph.indices.astype(np.int64)
        w = alg.edge_values(eu, ev, new_graph.weights,
                            new_graph.out_degree())
        if alg.undirected:
            eu, ev = np.concatenate([eu, ev]), np.concatenate([ev, eu])
            w = np.concatenate([w, w])
        peu, pev = perm[eu], perm[ev]
        ekey = (pev // t) * ntiles + (peu // t)
        kpos = np.searchsorted(dkeys, ekey)
        sel = np.flatnonzero(
            (kpos < dkeys.size)
            & (dkeys[np.minimum(kpos, dkeys.size - 1)] == ekey))
        fresh = np.full((dkeys.size, t, t), np.float32(sr.zero),
                        dtype=np.float32)
        lin = (kpos[sel] * t + peu[sel] % t) * t + pev[sel] % t
        _scatter_edges(sr, fresh.reshape(-1), lin,
                       w[sel].astype(np.float32))

        # old values of the same cells (⊕-identity where no block exists
        # yet): only the dirty blocks leave the device
        old_keys = (self.bdst.cpu().numpy().astype(np.int64) * ntiles
                    + self.bsrc.cpu().numpy().astype(np.int64))
        nb = old_keys.size
        opos = np.searchsorted(old_keys, dkeys)
        exists = ((opos < nb)
                  & (old_keys[np.minimum(opos, nb - 1)] == dkeys))
        opos_e = torch.as_tensor(opos[exists], device=self.device)
        old = np.full_like(fresh, np.float32(sr.zero))
        if opos_e.numel():
            old[exists] = self.blocks.index_select(0, opos_e).cpu().numpy()
        monotone = sr.monotone_under(old, fresh)

        # affected sources: original ids of the lanes whose out-edge
        # cells changed -- the warm-start frontier seed
        blk, row = np.nonzero((old != fresh).any(axis=2))
        pos = (dkeys[blk] % ntiles) * t + row
        affected = np.unique(self.inv_perm[pos[pos < self.n]]).astype(
            np.int64)

        # a from-scratch build keeps exactly the non-empty tile pairs and
        # the diagonal (it initializes each destination's carry)
        empty = ~(fresh != np.float32(sr.zero)).any(axis=(1, 2))
        diag = (dkeys // ntiles) == (dkeys % ntiles)
        grow = ~exists & ~empty
        drop = exists & empty & ~diag
        fresh_t = torch.from_numpy(fresh).to(self.device)
        if not grow.any() and not drop.any():
            blocks = self.blocks
            if opos_e.numel():
                blocks = blocks.clone()
                blocks.index_copy_(0, opos_e, fresh_t[exists])
            new_bg = dataclasses.replace(
                self, blocks=blocks, version=new_graph.version, graph_fp=fp)
            shape_changed = False
        else:
            keep = np.ones(nb, dtype=bool)
            keep[opos[drop]] = False
            keys2 = np.sort(np.concatenate([old_keys[keep], dkeys[grow]]))
            # every new position gathers its old block (grown positions
            # gather block 0 and are overwritten with their fresh block)
            src = np.zeros(keys2.size, dtype=np.int64)
            src[np.searchsorted(keys2, old_keys[keep])] = np.flatnonzero(keep)
            blocks = self.blocks.index_select(
                0, torch.as_tensor(src, device=self.device))
            put = (exists & ~drop) | grow
            blocks[torch.as_tensor(np.searchsorted(keys2, dkeys[put]),
                                   device=self.device)] = fresh_t[put]
            new_bg = dataclasses.replace(
                self, blocks=blocks,
                bsrc=torch.from_numpy((keys2 % ntiles).astype(np.int32))
                .to(self.device),
                bdst=torch.from_numpy((keys2 // ntiles).astype(np.int32))
                .to(self.device),
                dst_start=None, version=new_graph.version, graph_fp=fp)
            shape_changed = True
        return new_bg, UpdateDelta(
            monotone=monotone, shape_changed=shape_changed,
            affected_src=affected, n_blocks_rebuilt=int(dkeys.size),
            version=new_graph.version)


@dataclasses.dataclass(frozen=True)
class UpdateDelta:
    """What one `BlockedGraph.apply_updates` batch did, and whether the
    previous fixpoint may warm-start the recompute."""
    monotone: bool            # every changed cell ⊕-improved under an
                              # idempotent ⊕: resume from the old fixpoint
    shape_changed: bool       # the block list grew or shrank
    affected_src: np.ndarray  # original ids of sources whose out-edge
                              # cells changed -- the warm frontier seed
    n_blocks_rebuilt: int     # dirty tiles recomputed by this batch
    version: int              # Graph.version the new layout tracks


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
                 device: str | torch.device | None = None) -> BlockedGraph:
    """Block-sparse semiring adjacency for any registered algebra, on
    `device` (default: the CUDA device; raises without one). `order[k]`
    = original id of the vertex at tiled position k (default: identity).
    The numpy build is the reference's: edges from the CSR arrays, ⊗
    operands from `edge_values`, block ids from one `np.unique` over
    (bdst, bsrc) keys, parallel edges ⊕-combined by the semiring ufunc's
    `.at` scatter."""
    device = resolve_device(device, "build_blocks")
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
                        algebra=alg, version=graph.version,
                        graph_fp=graph.fingerprint())


def blocked_graph_from_numpy(arrays: Mapping, algebra: VertexAlgebra,
                             device: str | torch.device | None = None
                             ) -> BlockedGraph:
    """The port's `BlockedGraph` from another layout's fields as numpy
    arrays (`blocks`, `bsrc`, `bdst`, `perm`, `inv_perm`, `n`, `tile`):
    how identical inputs are carried across from the reference package."""
    n, tile = int(arrays["n"]), int(arrays["tile"])
    device = resolve_device(device, "blocked_graph_from_numpy")
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
