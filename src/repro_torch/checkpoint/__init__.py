"""The port's checkpointing (the counterpart of `repro.checkpoint`)."""
from repro_torch.checkpoint.manager import (CheckpointManager, load_pytree,
                                            save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
