from repro_torch.core.engine import ExecutionDetail, FlipEngine

__all__ = ["ExecutionDetail", "FlipEngine"]
