"""The LM stack of the port: config, layers, attention, mamba, MoE, the
model (inference and training), and the converter from the reference's
parameters."""
from repro_torch.models.config import BlockSpec, ModelConfig

__all__ = ["ModelConfig", "BlockSpec"]
