from repro_torch.core.arch import FlipArch, DEFAULT_ARCH
from repro_torch.core.vertex_program import (BFS, SSSP, WCC, WIDEST, REACH,
                                             PAGERANK, PROGRAMS,
                                             VertexProgram, get_algebra,
                                             register_algebra)
from repro_torch.core.mapping import (Mapping, RuntimeEstimator,
                                      compile_mapping)
from repro_torch.core.tables import (RoutingTables, build_tables,
                                     scatter_graph)
from repro_torch.core.sim import SimResult, simulate
from repro_torch.core import baselines
from repro_torch.core.engine import (ExecutionDetail, FlipEngine,
                                     mapping_order)

__all__ = [
    "FlipArch", "DEFAULT_ARCH",
    "BFS", "SSSP", "WCC", "WIDEST", "REACH", "PAGERANK",
    "PROGRAMS", "VertexProgram", "get_algebra", "register_algebra",
    "Mapping", "RuntimeEstimator", "compile_mapping",
    "RoutingTables", "build_tables", "scatter_graph",
    "SimResult", "simulate", "baselines",
    "ExecutionDetail", "FlipEngine", "mapping_order",
]
