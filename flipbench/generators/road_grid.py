"""Near-planar road network: a grid skeleton with random deletions.

A vectorised copy of the port's `make_road_network` (and of the JAX
package's, which it copies): the same random draws in the same order give
the same graph for the same seed, which `test_flipbench_generators.py`
holds. The grid's first n cells in serpentine row order are the vertices;
every right and down neighbour pair is an edge; a random spanning tree
(Kruskal over a random edge order) is protected, and each other edge is
deleted with probability `delete_frac`; weights are integers in
[1, max_weight]. The spanning tree comes from scipy's minimum spanning
tree over the edges' ranks in that random order, which is the tree the
sequential union-find picks.

Configuration keys: n, delete_frac, max_weight.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import minimum_spanning_tree

from flipbench.graph import RawGraph, csr_from_pairs


def grid_edges(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The skeleton's edges (u, v) in the generator's order: vertex by
    vertex, its right neighbour, then its lower one."""
    side = int(math.ceil(math.sqrt(n)))
    i = np.arange(n, dtype=np.int64)
    r, p = i // side, i % side
    c = np.where(r % 2 == 0, p, side - 1 - p)

    def index(rr, cc):
        return rr * side + np.where(rr % 2 == 0, cc, side - 1 - cc)

    right, down = index(r, c + 1), index(r + 1, c)
    ok = np.stack([(c + 1 < side) & (right < n),
                   (r + 1 < side) & (down < n)], axis=1).ravel()
    u = np.repeat(i, 2)[ok]
    v = np.stack([right, down], axis=1).ravel()[ok]
    return u, v


def generate(config: dict, seed: int) -> RawGraph:
    n = int(config["n"])
    delete_frac = float(config["delete_frac"])
    max_weight = int(config["max_weight"])
    rng = np.random.default_rng(seed)
    u, v = grid_edges(n)
    e = len(u)
    order = rng.permutation(e)
    rank = np.empty(e, dtype=np.float64)
    rank[order] = np.arange(1, e + 1)
    tree = minimum_spanning_tree(csr_matrix((rank, (u, v)),
                                            shape=(n, n))).tocoo()
    protected = np.zeros(e, dtype=bool)
    protected[order[tree.data.astype(np.int64) - 1]] = True
    keep = protected | (rng.random(e) > delete_frac)
    w = rng.integers(1, max_weight + 1,
                     size=int(keep.sum())).astype(np.float32)
    return csr_from_pairs(n, u[keep], v[keep], w, directed=False)
