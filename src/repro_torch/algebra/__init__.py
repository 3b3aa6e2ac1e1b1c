from repro_torch.algebra.semiring import (MIN_PLUS, MAX_MIN, OR_AND,
                                          PLUS_TIMES, SEMIRINGS, Semiring)
from repro_torch.algebra.programs import (ALGEBRAS, BFS, LABELPROP,
                                          MULTI_BFS, PAGERANK, REACH, SSSP,
                                          WCC, WIDEST, VertexAlgebra,
                                          get_algebra, landmarks,
                                          register_algebra)

__all__ = [
    "Semiring", "SEMIRINGS",
    "MIN_PLUS", "MAX_MIN", "OR_AND", "PLUS_TIMES",
    "VertexAlgebra", "ALGEBRAS", "get_algebra", "register_algebra",
    "BFS", "SSSP", "WCC", "WIDEST", "REACH", "PAGERANK",
    "MULTI_BFS", "LABELPROP", "landmarks",
]
