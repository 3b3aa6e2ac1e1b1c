"""Gradient compression with error feedback: the port of
`repro.distributed.compression` (`_quant`, `_dequant`, `compress_grads`,
`init_feedback`, `compressed_psum`).

int8 quantization with a per-tensor scale and an error-feedback buffer:

  q = round(g / s) clipped to [-127, 127], s = max|g + feedback| / 127
  feedback' = (g + feedback) - q * s    (re-injected into the next step)

`compress_grads` is the stage between the gradient and the optimizer
(`launch.steps.make_train_step(grad_compression=compress_grads)`), over
dicts of tensors keyed by parameter name. `compressed_psum` is the int8
wire exchange over one axis of the ambient device mesh (the reference's,
inside `shard_map` over the 'pod' axis): the scale's maximum and the int8
values summed as int32, both by `all_reduce`, over that axis's group;
`compressed_psum_plain` is the same arithmetic over a stacked rank axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _quant(g: torch.Tensor, feedback: torch.Tensor | None):
    g32 = g.float()
    if feedback is not None:
        g32 = g32 + feedback
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: dict, feedback_tree: dict | None
                   ) -> tuple[dict, dict]:
    """Quantize -> dequantize each gradient with error feedback
    (`feedback_tree`, keyed as `grads`, or None). Returns (gradients in
    their dtypes, new feedback (f32)), keyed as `grads`."""
    new_g, new_fb = {}, {}
    for name, g in grads.items():
        q, scale, g32 = _quant(g, None if feedback_tree is None
                               else feedback_tree[name])
        deq = _dequant(q, scale)
        new_g[name] = deq.to(g.dtype)
        new_fb[name] = g32 - deq
    return new_g, new_fb


def init_feedback(params: dict) -> dict:
    """Zero f32 feedback, one per tensor of `params` ({name: tensor})."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _requant(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def compressed_psum(x: torch.Tensor, axis_name: str, feedback=None):
    """int8-wire mean over the ranks of the ambient mesh's `axis_name`.

    Each rank quantizes its `x` (+ `feedback`); the group takes the MAX of
    the per-rank scales, every rank requantizes against it, the int8
    values are summed as int32 and dequantized with the group scale, and
    the sum is divided by the group size. Returns ``(mean (f32), new
    feedback (f32))``, as the reference does."""
    from repro_torch.distributed.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"compressed_psum over {axis_name!r}: the ambient "
                         "mesh has no such axis (set one with "
                         "distributed.mesh_context)")
    group = mesh[axis_name].get_group()
    _, scale, g32 = _quant(x, feedback)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    # requantize against the group scale so the int32 sum is consistent
    q = _requant(g32, scale_max)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = dist.get_world_size(group)
    mean = total.float() * scale_max / float(n)
    return mean, g32 - _dequant(q, scale_max)


def compressed_psum_plain(xs: torch.Tensor, feedback=None):
    """`compressed_psum` over a stacked rank axis: xs (W, ...) holds each
    rank's input, `feedback` (W, ...) or None. Returns ``(mean, new
    feedback)``, each (W, ...): every row the mean, and each rank's own
    residual."""
    g32 = xs.float()
    if feedback is not None:
        g32 = g32 + feedback
    w = xs.shape[0]
    scale = torch.clamp(g32.reshape(w, -1).abs().amax(dim=1), min=1e-12) \
        / 127.0
    scale_max = scale.max()
    q = _requant(g32, scale_max)
    total = q.to(torch.int32).sum(dim=0)
    mean = total.float() * scale_max / float(w)
    return (mean.expand_as(g32).clone(), g32 - _dequant(q, scale_max))
