"""repro_torch: the FLIP graph engine ported to PyTorch and CUDA (H100).

The counterpart of `repro`, module for module (`repro/X/y.py` ->
`repro_torch/X/y.py`). It imports torch and numpy only -- never jax and
nothing of `repro`; where it needs one of the reference's numpy modules
it keeps its own copy.

Layers ported so far (the graph query path):
  repro_torch.graphs     -- CSR, Table-4 generators, numpy oracles
  repro_torch.algebra    -- semirings and vertex algebras in torch
  repro_torch.kernels    -- the frontier relax step: CUDA kernel + plain
                            PyTorch version
  repro_torch.core       -- FlipEngine: the host-driven fixpoint
  repro_torch.api        -- compile(graph, program, plan).query(srcs)
                            (alias: `import flip_torch`)
  repro_torch.launch     -- graph_run
"""

__version__ = "0.1.0"

_API_EXPORTS = ("compile", "Program", "ExecutionPlan", "CompiledQuery",
                "QueryResult")


def __getattr__(name):
    # `repro_torch.compile(...)` without importing the engine stack at
    # package import time
    if name in _API_EXPORTS:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
