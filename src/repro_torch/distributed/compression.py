"""Gradient compression with error feedback: the port of
`repro.distributed.compression` (`_quant`, `_dequant`, `compress_grads`,
`init_feedback`).

int8 quantization with a per-tensor scale and an error-feedback buffer:

  q = round(g / s) clipped to [-127, 127], s = max|g + feedback| / 127
  feedback' = (g + feedback) - q * s    (re-injected into the next step)

`compress_grads` is the stage between the gradient and the optimizer
(`launch.steps.make_train_step(grad_compression=compress_grads)`), over
dicts of tensors keyed by parameter name. The reference's
`compressed_psum`, the int8 wire exchange inside `shard_map` over the
'pod' axis, needs a device mesh and waits for ROADMAP item 11.4.
"""
from __future__ import annotations

import torch


def _quant(g: torch.Tensor, feedback: torch.Tensor | None):
    g32 = g.float()
    if feedback is not None:
        g32 = g32 + feedback
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: dict, feedback: dict | None
                   ) -> tuple[dict, dict]:
    """Quantize -> dequantize each gradient with error feedback. Returns
    (gradients in their dtypes, new feedback (f32)), keyed as `grads`."""
    new_g, new_fb = {}, {}
    for name, g in grads.items():
        q, scale, g32 = _quant(g, None if feedback is None
                               else feedback[name])
        deq = _dequant(q, scale)
        new_g[name] = deq.to(g.dtype)
        new_fb[name] = g32 - deq
    return new_g, new_fb


def init_feedback(params: dict) -> dict:
    """Zero f32 feedback, one per tensor of `params` ({name: tensor})."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
