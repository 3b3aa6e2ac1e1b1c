"""The Graph500 Kronecker generator (graph500.org specification).

N = 2**scale vertices and M = edgefactor x N edges; each edge picks one
bit of its endpoints per level with initiator probabilities A, B, C
(D = 1 - A - B - C); the vertex labels and the edge order are then
permuted at random, as the specification's reference code does. Weights
are uniform in (0, 1], as Graph500's kernel 3 asks. Self-loops are
dropped and parallel edges merged (the lightest kept), and the graph is
made undirected.

Configuration keys: scale, edgefactor, A, B, C.
"""
from __future__ import annotations

import numpy as np

from flipbench.graph import RawGraph, csr_from_pairs


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, rng: np.random.Generator):
    """The specification's edge list: (ii, jj) of M = edgefactor x 2**scale
    edges, labels and order permuted."""
    n = 1 << scale
    m = edgefactor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = np.zeros(m, dtype=np.int64)
    jj = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ii += ii_bit.astype(np.int64) << level
        jj += jj_bit.astype(np.int64) << level
    p = rng.permutation(n)
    ii, jj = p[ii], p[jj]
    q = rng.permutation(m)
    return ii[q], jj[q]


def generate(config: dict, seed: int) -> RawGraph:
    scale = int(config["scale"])
    rng = np.random.default_rng(seed)
    ii, jj = kronecker_edges(scale, int(config["edgefactor"]),
                             float(config["A"]), float(config["B"]),
                             float(config["C"]), rng)
    w = (1.0 - rng.random(len(ii))).astype(np.float32)   # (0, 1]
    keep = ii != jj
    lo = np.minimum(ii, jj)[keep]
    hi = np.maximum(ii, jj)[keep]
    w = w[keep]
    n = 1 << scale
    key = lo * n + hi
    order = np.lexsort((w, key))                 # lightest first per pair
    key, w = key[order], w[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key, w = key[first], w[first]
    return csr_from_pairs(n, key // n, key % n, w, directed=False)
