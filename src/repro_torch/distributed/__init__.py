"""repro_torch.distributed: what the port has of `repro.distributed`.

  * `health` -- `HeartbeatMonitor`, the watchdog the bucket graph server
    beats around every dispatch and the trainer every step; `StepFailure`
    and `step_guard`, which name a failed train step.
  * `compression` -- int8 gradient compression with error feedback.
  * `moe_ep` -- expert-parallel MoE dispatch over a `torch.distributed`
    process group (two `all_to_all_single`s around each rank's experts).

The distributed graph fixpoint lives in `repro_torch.core.engine`
(`FlipEngine.execute(distributed=True)`). Still to be ported (ROADMAP
Queue 1 item 11.4): sharding rules, `compressed_psum` (the int8 wire
exchange over a mesh).
"""
from repro_torch.distributed.health import (HeartbeatMonitor, StepFailure,
                                            step_guard)

__all__ = ["HeartbeatMonitor", "StepFailure", "step_guard"]
