"""CSR graph container used by every FLIP layer (compiler, simulator, engine).

The paper's graphs (Table 4) are small (64..16k vertices) with low, balanced
in/out degree, so a plain numpy CSR is the right host-side representation.
The engine re-blocks this into dense tile-pairs (see
repro_torch.kernels.frontier.ops.build_blocks).

The port's own copy of `repro.graphs.csr`, kept array-for-array equal to
it (tests/test_torch_graphs.py holds the two against each other).
"""
from __future__ import annotations

import dataclasses
import hashlib
import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed weighted graph in CSR form.

    Undirected graphs are stored with both half-edges present (matching the
    paper's edge counts for road networks, which count directed half-edges).

    Instances are treated as immutable: streaming mutations go through
    `apply_updates`, which returns a NEW Graph with `version` bumped, so
    downstream caches (blocked layouts, compiled engines) can tell graph
    generations apart via `version` / `fingerprint()`.
    """

    indptr: np.ndarray   # (n+1,) int32
    indices: np.ndarray  # (m,)   int32  -- destination vertex of each edge
    weights: np.ndarray  # (m,)   float32
    directed: bool = True
    version: int = 0     # bumped by every apply_updates
    _fp: str | None = dataclasses.field(default=None, init=False,
                                        repr=False, compare=False)

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(n: int, edges, weights=None, directed: bool = True) -> "Graph":
        """Build from an iterable of (u, v) pairs. Deduplicates."""
        pairs = [(int(u), int(v)) for u, v in edges]
        if weights is None:
            wmap = {e: 1.0 for e in pairs}
        else:
            wmap = {}
            for (u, v), w in zip(pairs, weights):    # pre-sort alignment
                wmap[(u, v)] = min(float(w), wmap.get((u, v), np.inf))
        edges = sorted(set(pairs))
        if not directed:
            full = {}
            for (u, v), w in wmap.items():
                full[(u, v)] = w
                full[(v, u)] = w
            wmap = full
            edges = sorted(wmap)
        indptr = np.zeros(n + 1, dtype=np.int32)
        for u, _ in edges:
            indptr[u + 1] += 1
        indptr = np.cumsum(indptr).astype(np.int32)
        indices = np.asarray([v for _, v in edges], dtype=np.int32)
        w = np.asarray([wmap[e] for e in edges], dtype=np.float32)
        return Graph(indptr=indptr, indices=indices, weights=w, directed=directed)

    # ------------------------------------------------------------------ #
    # streaming mutations (versioned: always returns a new Graph)
    # ------------------------------------------------------------------ #
    def apply_updates(self, updates) -> "Graph":
        """Apply a batch of edge mutations; returns a NEW Graph (this one
        is never modified) with `version` bumped by one.

        `updates` is an iterable of `(u, v, w)` triples: any float `w`
        upserts the edge (inserts it if absent, overwrites its weight
        otherwise), `w = None` deletes it (deleting an absent edge is a
        no-op, so idempotent streams replay safely). `(u, v)` pairs are
        accepted as shorthand for `(u, v, 1.0)`. Within one batch, later
        entries win for the same `(u, v)`. Undirected graphs keep both
        half-edges in sync automatically. The vertex set is fixed: an
        endpoint outside `[0, n)` raises (grow the graph by building a
        new one from edges).

        Pass a *sequence*, not a one-shot iterator, when the same batch
        is then replayed into `BlockedGraph`/`FlipEngine.apply_updates`
        -- each call consumes the iterable once.
        """
        n = self.n
        ops: dict[tuple[int, int], float | None] = {}
        for upd in updates:
            if len(upd) == 2:
                (u, v), w = upd, 1.0
            else:
                u, v, w = upd
            u, v = int(u), int(v)
            if not (0 <= u < n and 0 <= v < n):
                raise ValueError(
                    f"edge update ({u}, {v}) is outside the fixed vertex "
                    f"set [0, {n}); apply_updates cannot grow the graph")
            w = None if w is None else float(w)
            ops[(u, v)] = w
            if not self.directed:
                ops[(v, u)] = w

        eu = self.edge_sources()
        ev = self.indices.astype(np.int64)
        if ops:
            # drop every existing edge named by the batch, then append the
            # surviving upserts and re-sort -- one vectorized pass, no
            # per-edge Python over the untouched edges
            ukey = np.asarray([u * n + v for (u, v) in ops],
                              dtype=np.int64)
            keep = ~np.isin(eu * n + ev, ukey)
            ins = [(u, v, w) for (u, v), w in ops.items() if w is not None]
            au = np.concatenate([eu[keep], np.asarray(
                [e[0] for e in ins], dtype=np.int64)])
            av = np.concatenate([ev[keep], np.asarray(
                [e[1] for e in ins], dtype=np.int64)])
            aw = np.concatenate([self.weights[keep], np.asarray(
                [e[2] for e in ins], dtype=np.float32)])
        else:
            au, av, aw = eu, ev, self.weights
        order = np.argsort(au * n + av, kind="stable")
        au, av, aw = au[order], av[order], aw[order]
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(au, minlength=n))]).astype(np.int32)
        return Graph(indptr=indptr, indices=av.astype(np.int32),
                     weights=aw.astype(np.float32), directed=self.directed,
                     version=self.version + 1)

    def fingerprint(self) -> str:
        """Cheap content hash of the CSR arrays (+ version), cached on
        first use. Because Graph instances are treated as immutable
        (`apply_updates` returns a new one), the cache never goes stale;
        engine caches key on this to detect graph swaps."""
        if self._fp is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{self.n}|{self.version}|{self.directed}".encode())
            for a in (self.indptr, self.indices, self.weights):
                h.update(np.ascontiguousarray(a).tobytes())
            self._fp = h.hexdigest()
        return self._fp

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return len(self.indices)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def edge_weights(self, u: int) -> np.ndarray:
        return self.weights[self.indptr[u]:self.indptr[u + 1]]

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edge_sources(self) -> np.ndarray:
        """(m,) int64 source vertex of each CSR edge (the expansion of
        `indptr`, pairing with `indices`/`weights` positionally)."""
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))

    def edge_list(self):
        """Yield (u, v, w) triples."""
        for u in range(self.n):
            for k in range(self.indptr[u], self.indptr[u + 1]):
                yield u, int(self.indices[k]), float(self.weights[k])

    def reverse(self) -> "Graph":
        """Graph with all edges flipped (used for in-neighbor queries)."""
        edges = [(v, u) for u, v, _ in self.edge_list()]
        ws = [w for _, _, w in self.edge_list()]
        return Graph.from_edges(self.n, edges, ws, directed=True)

    def in_neighbors_map(self):
        """dict: v -> list of (u, w) over incoming edges. Host-side helper."""
        inc = {v: [] for v in range(self.n)}
        for u, v, w in self.edge_list():
            inc[v].append((u, w))
        return inc

    # ------------------------------------------------------------------ #
    # dense forms for the JAX engine / reference oracles
    # ------------------------------------------------------------------ #
    def dense_weights(self, inf: float = np.inf) -> np.ndarray:
        """(n, n) matrix W[u, v] = weight of edge u->v, `inf` if absent."""
        W = np.full((self.n, self.n), inf, dtype=np.float32)
        for u, v, w in self.edge_list():
            W[u, v] = min(W[u, v], w)
        return W

    def permuted(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new id of old vertex i is perm[i]."""
        perm = np.asarray(perm)
        edges = [(perm[u], perm[v]) for u, v, _ in self.edge_list()]
        ws = [w for _, _, w in self.edge_list()]
        return Graph.from_edges(self.n, edges, ws, directed=True)

    # ------------------------------------------------------------------ #
    # structure metrics used by the mapping compiler
    # ------------------------------------------------------------------ #
    def undirected_adjacency(self):
        adj = {v: set() for v in range(self.n)}
        for u, v, _ in self.edge_list():
            adj[u].add(v)
            adj[v].add(u)
        return adj

    def bfs_levels_from(self, src: int) -> np.ndarray:
        """Unweighted hop distance from src over the undirected skeleton."""
        adj = self.undirected_adjacency()
        dist = np.full(self.n, -1, dtype=np.int64)
        dist[src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[v] < 0:
                        dist[v] = d
                        nxt.append(v)
            frontier = nxt
        return dist

    def center_vertex(self, sample: int = 32, seed: int = 0) -> int:
        """Vertex with (approximately) minimum eccentricity.

        Exact for n <= sample; sampled double-sweep otherwise. The paper
        seeds beam search from the graph center (Sec. 4.2.1).
        """
        rng = np.random.default_rng(seed)
        if self.n <= sample:
            cands = np.arange(self.n)
        else:
            cands = rng.choice(self.n, size=sample, replace=False)
        best, best_ecc = int(cands[0]), np.iinfo(np.int64).max
        for c in cands:
            lv = self.bfs_levels_from(int(c))
            ecc = lv.max() if (lv >= 0).all() else lv[lv >= 0].max() + self.n
            if ecc < best_ecc:
                best, best_ecc = int(c), ecc
        return best

    def is_connected(self) -> bool:
        return bool((self.bfs_levels_from(0) >= 0).all())
