"""Reference (oracle) graph algorithms in plain numpy.

The port's own copy of `repro.graphs.reference`: the ground truth the
PyTorch engine and its CUDA kernel are checked against. They double as the
"MCU" algorithm implementations (the paper's MCU baseline runs the
textbook-optimal algorithms: BFS O(|V|+|E|), SSSP via binary-heap Dijkstra
O(|E|+|V|log|V|), WCC O(|V|+|E|)).

Each function also returns lightweight op counts that the MCU cycle model
(repro.core.baselines) converts into cycles.
"""
from __future__ import annotations

import heapq
import numpy as np

from repro_torch.graphs.csr import Graph

INF = np.float32(np.inf)


def bfs(g: Graph, src: int):
    """Hop levels from src. Returns (levels f32 (n,), stats)."""
    level = np.full(g.n, INF, dtype=np.float32)
    level[src] = 0.0
    frontier = [src]
    edges_relaxed = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in g.neighbors(u):
                edges_relaxed += 1
                if level[v] == INF:
                    level[v] = level[u] + 1.0
                    nxt.append(int(v))
        frontier = nxt
    return level, {"edges_relaxed": edges_relaxed}


def sssp(g: Graph, src: int):
    """Dijkstra with a binary heap. Returns (dist f32 (n,), stats)."""
    dist = np.full(g.n, INF, dtype=np.float32)
    dist[src] = 0.0
    heap = [(0.0, src)]
    edges_relaxed = 0
    pops = 0
    while heap:
        d, u = heapq.heappop(heap)
        pops += 1
        if d > dist[u]:
            continue
        base = g.indptr[u]
        for k in range(base, g.indptr[u + 1]):
            v = int(g.indices[k])
            w = float(g.weights[k])
            edges_relaxed += 1
            nd = d + w
            if nd < dist[v]:
                dist[v] = np.float32(nd)
                heapq.heappush(heap, (nd, v))
    return dist, {"edges_relaxed": edges_relaxed, "heap_pops": pops}


def wcc(g: Graph):
    """Weakly connected components by min-label propagation.

    Returns (labels f32 (n,) — min vertex id in the component, stats).
    """
    adj = g.undirected_adjacency()
    label = np.arange(g.n, dtype=np.float32)
    edges_relaxed = 0
    changed = True
    while changed:
        changed = False
        for u in range(g.n):
            for v in adj[u]:
                edges_relaxed += 1
                if label[v] < label[u]:
                    label[u] = label[v]
                    changed = True
                elif label[u] < label[v]:
                    label[v] = label[u]
                    changed = True
    return label, {"edges_relaxed": edges_relaxed}


def pagerank(g: Graph, damping: float = 0.85, tol: float = 1e-12,
             max_iters: int = 10_000):
    """PageRank without dangling-mass redistribution: the fixpoint of

        p = (1-d)/n + d * sum_{u -> v} p[u] / outdeg(u)

    solved by Jacobi iteration in float64 (the power series sum_k M^k b,
    which is exactly what the engine's delta-push accumulates).
    Returns (rank f32 (n,), stats).
    """
    n = g.n
    deg = g.out_degree().astype(np.float64)
    b = (1.0 - damping) / n
    p = np.zeros(n, dtype=np.float64)
    iters = 0
    edges_relaxed = 0
    for iters in range(1, max_iters + 1):
        contrib = np.where(deg > 0, p / np.maximum(deg, 1), 0.0)
        new = np.full(n, b)
        for u in range(n):
            lo, hi = g.indptr[u], g.indptr[u + 1]
            if contrib[u]:
                new[g.indices[lo:hi]] += damping * contrib[u]
            edges_relaxed += hi - lo
        delta = np.abs(new - p).max()
        p = new
        if delta < tol:
            break
    return p.astype(np.float32), {"edges_relaxed": edges_relaxed,
                                  "iterations": iters}


def widest(g: Graph, src: int):
    """Widest (maximum-bottleneck) path via max-heap Dijkstra.

    width(src) = +inf; unreachable vertices stay -inf.
    Returns (width f32 (n,), stats).
    """
    width = np.full(g.n, -np.inf, dtype=np.float32)
    width[src] = np.inf
    heap = [(-np.inf, src)]           # max-heap via negated widths
    edges_relaxed = 0
    pops = 0
    while heap:
        negw, u = heapq.heappop(heap)
        pops += 1
        if -negw < width[u]:
            continue
        for k in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[k])
            w = float(g.weights[k])
            edges_relaxed += 1
            cand = min(float(width[u]), w)
            if cand > width[v]:
                width[v] = np.float32(cand)
                heapq.heappush(heap, (-cand, v))
    return width, {"edges_relaxed": edges_relaxed, "heap_pops": pops}


def reach(g: Graph, src: int):
    """Directed reachability from src as {0.0, 1.0} floats.
    Returns (reachable f32 (n,), stats)."""
    seen = np.zeros(g.n, dtype=bool)
    seen[src] = True
    frontier = [src]
    edges_relaxed = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in g.neighbors(u):
                edges_relaxed += 1
                if not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return seen.astype(np.float32), {"edges_relaxed": edges_relaxed}


# ---------------------------------------------------------------------- #
# vector-state oracles: (n, d) feature blocks, column f seeded from
# landmark f of `landmarks(n, src, d)` (landmark 0 == src). Shared with
# the algebras through the same landmark convention, so the engine and
# the oracle agree on seeding by construction.
# ---------------------------------------------------------------------- #
def multi_bfs(g: Graph, src: int, d: int = 8):
    """Multi-landmark BFS embedding: column f is the hop-level vector
    from landmark f. Returns (levels f32 (n, d), stats)."""
    from repro_torch.algebra.programs import landmarks
    lm = landmarks(g.n, src, d)
    cols, edges = [], 0
    for f in range(d):
        lev, st = bfs(g, int(lm[f]))
        cols.append(lev)
        edges += st["edges_relaxed"]
    return np.stack(cols, axis=1), {"edges_relaxed": edges}


def labelprop(g: Graph, src: int, d: int = 8, damping: float = 0.85,
              tol: float = 1e-12, max_iters: int = 10_000):
    """Seeded label spreading under the damped-walk (+, x) operator:
    column f is the fixpoint of

        p_f = b_f + damping * sum_{u -> v} p_f[u] / outdeg(u)

    with b_f = (1 - damping) * onehot(landmark f) -- the power series
    sum_k (damping M)^k b_f the engine's residual push accumulates.
    argmax over the feature axis is the propagated community label.
    Returns (masses f32 (n, d), stats)."""
    from repro_torch.algebra.programs import landmarks
    n = g.n
    lm = landmarks(n, src, d)
    deg = g.out_degree().astype(np.float64)
    b = np.zeros((n, d), dtype=np.float64)
    b[lm, np.arange(d)] = 1.0 - damping
    p = np.zeros((n, d), dtype=np.float64)
    iters = 0
    edges_relaxed = 0
    for iters in range(1, max_iters + 1):
        contrib = np.where(deg[:, None] > 0,
                           p / np.maximum(deg, 1)[:, None], 0.0)
        new = b.copy()
        for u in range(n):
            lo, hi = g.indptr[u], g.indptr[u + 1]
            if contrib[u].any():
                new[g.indices[lo:hi]] += damping * contrib[u]
            edges_relaxed += hi - lo
        delta = np.abs(new - p).max()
        p = new
        if delta < tol:
            break
    return p.astype(np.float32), {"edges_relaxed": edges_relaxed,
                                  "iterations": iters}


# ---------------------------------------------------------------------- #
# oracle registry: one entry per registered algorithm, so `run` dispatch
# and `repro.api.Program` registration share a single table. Every oracle
# is normalized to the `(graph, src) -> (result, stats)` signature
# (src-free algorithms ignore src; stats may be empty).
# ---------------------------------------------------------------------- #
ORACLES = {
    "bfs": bfs,
    "sssp": sssp,
    "wcc": lambda g, src=0: wcc(g),
    "pagerank": lambda g, src=0: pagerank(g),
    "widest": widest,
    "reach": reach,
    "multi_bfs": multi_bfs,
    "labelprop": labelprop,
}


def register_oracle(name: str, fn) -> None:
    """Register `fn(graph, src)` as the ground truth for algorithm
    `name`. `fn` may return just the result vector or `(result, stats)`;
    `run` normalizes either form. `repro.api.Program` calls this
    atomically with the `VertexAlgebra` registration."""
    ORACLES[name] = fn


def get_oracle(name: str):
    """The registered oracle callable, or None if the algorithm has no
    numpy ground truth (engine-only algebras)."""
    return ORACLES.get(name)


def run(algo: str, g: Graph, src: int = 0):
    fn = ORACLES.get(algo)
    if fn is None:
        raise ValueError(f"unknown algorithm {algo!r}")
    out = fn(g, src)
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1],
                                                               dict):
        return out
    return np.asarray(out), {}
