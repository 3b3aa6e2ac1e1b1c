"""The port's optimizer: hand-rolled AdamW and its cosine schedule (the
counterpart of `repro.optim`)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    cosine_schedule,
    global_norm,
    init_opt_state,
)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm"]
