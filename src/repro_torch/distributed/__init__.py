"""repro_torch.distributed: what the port has of `repro.distributed`.

  * `health` -- `HeartbeatMonitor`, the watchdog the bucket graph server
    beats around every dispatch.
  * `moe_ep` -- expert-parallel MoE dispatch over a `torch.distributed`
    process group (two `all_to_all_single`s around each rank's experts).

The distributed graph fixpoint lives in `repro_torch.core.engine`
(`FlipEngine.execute(distributed=True)`). Still to be ported (ROADMAP
Queue 1 item 11): sharding rules, compression, the trainer's
`StepFailure`/`step_guard`.
"""
from repro_torch.distributed.health import HeartbeatMonitor

__all__ = ["HeartbeatMonitor"]
