"""Vertex-centric programs (paper Fig. 5 and Sec. 5.1).

The port's copy of `repro.core.vertex_program`: a vertex program is an
(Apply, Scatter) pair over a semiring -- an incoming message carrying
the source vertex's attribute is ⊗-combined with the edge weight,
⊕-merged into the destination attribute, and scattered onward iff the
attribute became active. The program *is* a
`repro_torch.algebra.VertexAlgebra`; this module re-exports the registry
under the names the cycle simulator, routing tables and mapping
compiler import.

Instruction counts per paper Sec. 5.1: 4/5/5 (WCC/BFS/SSSP) when the
attribute updates, 2/4/4 when it does not.
"""
from __future__ import annotations

import numpy as np

from repro_torch.algebra import (ALGEBRAS, BFS, PAGERANK, REACH, SSSP, WCC,
                                 WIDEST, VertexAlgebra, get_algebra,
                                 register_algebra)

# The vertex program *is* the algebra; the alias keeps the simulator,
# tables and mapping compiler on the reference's names.
VertexProgram = VertexAlgebra

INF = np.float32(np.inf)

PROGRAMS = ALGEBRAS

__all__ = [
    "VertexProgram", "VertexAlgebra", "PROGRAMS", "INF",
    "BFS", "SSSP", "WCC", "WIDEST", "REACH", "PAGERANK",
    "get_algebra", "register_algebra",
]
