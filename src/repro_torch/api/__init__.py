"""repro_torch.api: the query surface of the port.

    import flip_torch                 # or: from repro_torch import api

    prog = flip_torch.Program.get("sssp")
    plan = flip_torch.ExecutionPlan(mode="data", tile=128)
    cq = flip_torch.compile(graph, prog, plan)   # on the CUDA device
    result = cq.query([0, 5, 9])                 # QueryResult
    cq2, delta = cq.update(edge_batch)           # streaming mutation
    warm = cq2.query([0, 5, 9], warm=result)     # incremental recompute
"""
from repro_torch.api.plan import (ExecutionPlan, plan_from_cli,
                                  resolve_cli_engine)
from repro_torch.api.program import Program
from repro_torch.api.session import CompiledQuery, QueryResult, compile
from repro_torch.core.engine import WarmStart
from repro_torch.obs.telemetry import DispatchTelemetry, QueryTelemetry
from repro_torch.resilience.errors import (BackendFailure, CapacityExceeded,
                                           ConvergenceFailure,
                                           DeadlineExceeded, FlipError,
                                           InvalidRequest)

__all__ = [
    "ExecutionPlan", "Program", "CompiledQuery", "QueryResult",
    "WarmStart", "compile", "plan_from_cli", "resolve_cli_engine",
    "QueryTelemetry", "DispatchTelemetry",
    "FlipError", "InvalidRequest", "CapacityExceeded",
    "DeadlineExceeded", "ConvergenceFailure", "BackendFailure",
]
