"""Step factories of the port (the counterpart of `repro.launch.steps`):
the prefill and decode steps that the serving launcher and `chip_smoke.py`
call. The reference's sharding and train-step parts wait for a later
slice (ROADMAP Queue 1 item 11)."""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


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
