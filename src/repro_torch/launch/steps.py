"""Step factories of the port (the counterpart of `repro.launch.steps`):
the train step that the trainer (`launch.train`) and `chip_smoke.py`
call, and the prefill and decode steps of the serving launcher. The
reference's sharding parts (`param_shardings`, `input_specs`, ...) need a
device mesh and wait for ROADMAP item 11.4."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    impl: str = "auto", moe_dispatch: str = "gspmd",
                    remat: bool = True, grad_compression=None, device=None):
    """(state, batch) -> (state, metrics). state = {"params": LM, "opt":
    `adamw.init_opt_state`'s dict}, plus "feedback" with
    `grad_compression` (`distributed.compression.compress_grads`). The
    parameters and moments are updated in place and the same dicts are
    returned. metrics = {"loss", "lr", "grad_norm"}, device tensors (read
    them on the host only when logging). batch holds "tokens" (or
    "frames") and "labels" on the parameters' device.

    `impl` and `moe_dispatch` are accepted for parity with the reference:
    the tensors' device picks the attention route (K2 under autograd on
    the card, `attention_ref` on the CPU; K3 under autograd through
    `ssd.ops.SSDIntra` on the card, `ssd_ref` on the CPU), and the MoE runs
    its one-group dispatch. Every config trains on either device, as in the
    reference. `device` (default: the CUDA device, which must exist) is
    where the caller will place the state."""
    del impl, moe_dispatch
    resolve_device(device, "make_train_step")

    def train_step(state, batch):
        params = state["params"]
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss = M.train_loss(params, batch, cfg, remat=remat)
            # a `frames` model declares an embedding it never reads
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), grads)}
        if grad_compression is not None:
            grads, feedback = grad_compression(grads, state.get("feedback"))
        _, opt, stats = adamw.adamw_update(grads, state["opt"], params,
                                           opt_cfg)
        new_state = {"params": params, "opt": opt}
        if grad_compression is not None:
            new_state["feedback"] = feedback
        return new_state, {"loss": loss.detach(), **stats}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B,1,V) f32. batch holds
    "tokens" (B,S), or "frames" (B,S,d) for the `frames` frontend."""
    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, tokens, pos) -> (logits (B,1,V) f32, cache)."""
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(params, cache, tokens, pos, cfg)
    return serve_step
