"""The raw graph every run makes from its seed, as CSR arrays.

Both sides get the same arrays: the port as its `Graph`, the reference as
edge lists. Nothing here imports the port at module level.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RawGraph:
    """A directed weighted graph in CSR form (an undirected graph holds
    both half-edges)."""
    indptr: np.ndarray     # (n + 1,) int32
    indices: np.ndarray    # (m,) int32, destination of each half-edge
    weights: np.ndarray    # (m,) float32
    directed: bool

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def m(self) -> int:
        return len(self.indices)

    def sources(self) -> np.ndarray:
        """(m,) int64 source vertex of each half-edge."""
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_port(self):
        """The port's `Graph` over the same arrays."""
        from repro_torch.graphs.csr import Graph
        return Graph(indptr=self.indptr, indices=self.indices,
                     weights=self.weights, directed=self.directed)


def csr_from_pairs(n: int, u: np.ndarray, v: np.ndarray, w: np.ndarray,
                   directed: bool) -> RawGraph:
    """CSR over half-edges (u, v, w) with no duplicate pair, sorted by
    (u, v); an undirected graph gets both half-edges of every pair."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    if not directed:
        u, v, w = (np.concatenate([u, v]), np.concatenate([v, u]),
                   np.concatenate([w, w]))
    order = np.lexsort((v, u))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])
    return RawGraph(indptr=indptr.astype(np.int32),
                    indices=v[order].astype(np.int32),
                    weights=w[order], directed=directed)
