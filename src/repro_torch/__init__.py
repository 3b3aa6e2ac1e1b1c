"""repro_torch: FLIP ported to PyTorch and CUDA (H100).

The counterpart of `repro`, module for module (`repro/X/y.py` ->
`repro_torch/X/y.py`). It imports torch and numpy only -- never jax and
nothing of `repro`; where it needs one of the reference's numpy modules
it keeps its own copy. Every entry point runs on the CUDA device unless
it is given `device="cpu"` (`device.resolve_device`).

Layers ported so far:
  repro_torch.graphs     -- CSR, Table-4 generators, numpy oracles
  repro_torch.algebra    -- semirings and vertex algebras in torch
  repro_torch.kernels    -- hand-written CUDA kernels, each beside its
                            plain PyTorch version: frontier relax, flash
                            attention, the SSD intra-chunk form
  repro_torch.core       -- FlipEngine: the host-driven fixpoint, warm
                            starts, tracing, the segment surface; the
                            FLIP mapping compiler, routing tables, the
                            cycle simulator and the baseline models
  repro_torch.api        -- compile(graph, program, plan, mapping=)
                            .query(srcs), update(batch) (alias:
                            `import flip_torch`)
  repro_torch.obs        -- step traces, metrics, Chrome-trace export,
                            the simulator bridge `from_sim`
  repro_torch.resilience -- typed errors, classify, finite_guard, the
                            degradation ladder, fault injection
  repro_torch.distributed -- HeartbeatMonitor
  repro_torch.serving    -- AsyncGraphServer: continuous batching
  repro_torch.autotune   -- the plan autotuner: profile, candidate space,
                            measured pricing through the kernel, cost
                            model, tuning store (ExecutionPlan(tuned=True))
  repro_torch.models     -- the LM stack for inference (no MoE yet)
  repro_torch.configs    -- qwen3-0.6b and mamba2-370m
  repro_torch.launch     -- graph_run (--engine jax | sim, --autotune),
                            serve_graph (the bucket GraphServer), autotune
                            (the sweep CLI), serve, prefill/decode steps
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
