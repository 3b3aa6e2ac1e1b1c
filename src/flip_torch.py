"""flip_torch: the front door of the PyTorch/CUDA port.

    import flip_torch

    cq = flip_torch.compile(graph, "sssp", flip_torch.ExecutionPlan())
    result = cq.query(5)              # on the CUDA device
    assert result.check()

The counterpart of `flip`, a thin alias of `repro_torch.api`. Sessions
run on the CUDA device unless `compile(..., device="cpu")` asks for the
CPU.
"""
from repro_torch.api import (BackendFailure, CapacityExceeded, CompiledQuery,
                             ConvergenceFailure, DeadlineExceeded,
                             ExecutionPlan, FlipError, InvalidRequest,
                             Program, QueryResult, WarmStart, compile,
                             plan_from_cli, resolve_cli_engine)

__all__ = [
    "ExecutionPlan", "Program", "CompiledQuery", "QueryResult",
    "WarmStart", "compile", "plan_from_cli", "resolve_cli_engine",
    "FlipError", "InvalidRequest", "CapacityExceeded",
    "DeadlineExceeded", "ConvergenceFailure", "BackendFailure",
]
