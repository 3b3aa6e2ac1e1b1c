"""repro_torch.distributed: what the port has of `repro.distributed`.

  * `health` -- `HeartbeatMonitor`, the watchdog the bucket graph server
    beats around every dispatch.

The rest (the distributed fixpoint, sharding, collectives, the trainer's
`StepFailure`/`step_guard`) is still to be ported (ROADMAP Queue 1).
"""
from repro_torch.distributed.health import HeartbeatMonitor

__all__ = ["HeartbeatMonitor"]
