"""repro_torch.distributed: the port of `repro.distributed`.

  * `sharding` -- logical-axis sharding over a `torch.distributed`
    `DeviceMesh`: `ShardingRules`, `DEFAULT_RULES`, `activation_rules`,
    `logical_to_pspec`, `constrain`, and the ambient mesh
    (`mesh_context`, `current_mesh`).
  * `health` -- `HeartbeatMonitor`, the watchdog the bucket graph server
    beats around every dispatch and the trainer every step; `StepFailure`
    and `step_guard`, which name a failed train step.
  * `compression` -- int8 gradient compression with error feedback, and
    `compressed_psum`, the int8 wire exchange over one mesh axis.
  * `moe_ep` -- expert-parallel MoE dispatch over a `torch.distributed`
    process group (two `all_to_all_single`s around each rank's experts).

The distributed graph fixpoint lives in `repro_torch.core.engine`
(`FlipEngine.execute(distributed=True)`); meshes are built by
`repro_torch.launch.mesh`.
"""
from repro_torch.distributed.health import (HeartbeatMonitor, StepFailure,
                                            step_guard)
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              activation_rules, constrain,
                                              current_mesh,
                                              logical_to_pspec,
                                              mesh_context)

__all__ = ["ShardingRules", "DEFAULT_RULES", "activation_rules",
           "constrain", "logical_to_pspec", "mesh_context", "current_mesh",
           "HeartbeatMonitor", "StepFailure", "step_guard"]
