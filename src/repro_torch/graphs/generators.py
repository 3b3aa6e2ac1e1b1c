"""Dataset generators matching Table 4 of the FLIP paper.

| Group    | Type       | Diameter | #Graphs | |V|       | |E|        |
| Tree     | Directed   | High     | 100     | 256      | 255        |
| SRN      | Undirected | High     | 100     | [64,107] | [146,278]  |
| LRN      | Undirected | High     | 100     | 256      | [584,898]  |
| Syn.     | Directed   | Low      | 100     | 256      | 768        |
| Ext. LRN | Undirected | High     | 10      | 16k      | [44k,50k]  |

The paper builds SRN/LRN by BFS-sampling the SNAP California / San Francisco
road networks with random seeds. SNAP data is not available offline, so we
generate *structurally equivalent* road networks: near-planar grid graphs
with random edge deletions (degree ~2..4, high diameter), which match the
published |V|/|E| ranges exactly. |E| counts directed half-edges for
undirected groups (that is how Table 4's road-network counts are consistent
with degree ~2.5 road graphs).
"""
from __future__ import annotations

import math
import numpy as np

from repro_torch.graphs.csr import Graph


def _grid_road_network(n: int, rng: np.random.Generator,
                       delete_frac: float, max_weight: int = 8) -> Graph:
    """Near-planar road-like network: grid skeleton + random deletions.

    A random spanning tree of the kept edges is protected so the graph stays
    connected (the paper's BFS-sampled subgraphs are connected by
    construction).
    """
    side = int(math.ceil(math.sqrt(n)))
    # Vertex ids: first n cells of the grid in row-major "serpentine" order
    # (keeps the induced subgraph connected).
    coords = []
    for r in range(side):
        cols = range(side) if r % 2 == 0 else range(side - 1, -1, -1)
        for c in cols:
            coords.append((r, c))
            if len(coords) == n:
                break
        if len(coords) == n:
            break
    idx = {rc: i for i, rc in enumerate(coords)}

    edges = []
    for (r, c), i in idx.items():
        for dr, dc in ((0, 1), (1, 0)):
            j = idx.get((r + dr, c + dc))
            if j is not None:
                edges.append((i, j))
    edges = np.asarray(edges)

    # Protected spanning tree via randomized union-find over shuffled edges.
    order = rng.permutation(len(edges))
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    protected = np.zeros(len(edges), dtype=bool)
    for k in order:
        u, v = edges[k]
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            protected[k] = True

    keep = protected | (rng.random(len(edges)) > delete_frac)
    kept = edges[keep]
    weights = rng.integers(1, max_weight + 1, size=len(kept)).astype(np.float32)
    return Graph.from_edges(n, [tuple(e) for e in kept], weights, directed=False)


def make_road_network(n: int, seed: int = 0, delete_frac: float = 0.35) -> Graph:
    rng = np.random.default_rng(seed)
    return _grid_road_network(n, rng, delete_frac)


def make_tree(n: int = 256, seed: int = 0, max_children: int = 4,
              max_weight: int = 8) -> Graph:
    """Random directed tree rooted at vertex 0 (|E| = n - 1)."""
    rng = np.random.default_rng(seed)
    edges = []
    # attach each vertex i>0 to a random earlier vertex with bounded fanout
    child_count = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        while True:
            p = int(rng.integers(0, i))
            if child_count[p] < max_children:
                break
        child_count[p] += 1
        edges.append((p, i))
    weights = rng.integers(1, max_weight + 1, size=len(edges)).astype(np.float32)
    return Graph.from_edges(n, edges, weights, directed=True)


def make_power_law(n: int = 128, m: int = 384, seed: int = 0,
                   exponent: float = 2.5, max_weight: int = 8) -> Graph:
    """Chung-Lu style directed power-law graph (hub-dominated degrees).

    Endpoint i is drawn with probability ~ (i+1)^(-1/(exponent-1)) under a
    random vertex relabeling, giving an expected degree sequence with tail
    exponent ~`exponent`. A spanning arborescence from vertex 0 keeps the
    graph reachable, like `make_synthetic`.
    """
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (exponent - 1.0))
    w = rng.permutation(w)
    p = w / w.sum()
    edges = set()
    perm = rng.permutation(n)
    order = [0] + [int(v) for v in perm if v != 0]
    for i in range(1, n):
        edges.add((order[int(rng.integers(0, i))], order[i]))
    tries = 0
    while len(edges) < m and tries < 50 * m:
        u = int(rng.choice(n, p=p))
        v = int(rng.choice(n, p=p))
        tries += 1
        if u != v:
            edges.add((u, v))
    weights = rng.integers(1, max_weight + 1,
                           size=len(edges)).astype(np.float32)
    return Graph.from_edges(n, sorted(edges), weights, directed=True)


def make_synthetic(n: int = 256, m: int = 768, seed: int = 0,
                   max_weight: int = 8) -> Graph:
    """Low-diameter random directed graph: m distinct random edges."""
    rng = np.random.default_rng(seed)
    edges = set()
    # spanning arborescence from 0 keeps most vertices reachable
    perm = rng.permutation(n)
    order = [0] + [int(v) for v in perm if v != 0]
    for i in range(1, n):
        edges.add((order[int(rng.integers(0, i))], order[i]))
    while len(edges) < m:
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v:
            edges.add((u, v))
    weights = rng.integers(1, max_weight + 1, size=len(edges)).astype(np.float32)
    return Graph.from_edges(n, sorted(edges), weights, directed=True)


# --------------------------------------------------------------------- #
# Table-4 dataset groups
# --------------------------------------------------------------------- #
DATASET_SPECS = {
    # group: (builder, default count)
    "Tree":    (lambda seed: make_tree(256, seed=seed), 100),
    "SRN":     (lambda seed: make_road_network(
        int(np.random.default_rng(seed).integers(64, 108)), seed=seed,
        delete_frac=0.70), 100),
    "LRN":     (lambda seed: make_road_network(256, seed=seed), 100),
    "Syn":     (lambda seed: make_synthetic(256, 768, seed=seed), 100),
    "ExtLRN":  (lambda seed: make_road_network(16384, seed=seed,
                                               delete_frac=0.56), 10),
}


def make_dataset(group: str, count: int | None = None, seed0: int = 0):
    """Yield `count` graphs of a Table-4 group."""
    builder, default_count = DATASET_SPECS[group]
    count = default_count if count is None else count
    for s in range(count):
        yield builder(seed0 + s)
