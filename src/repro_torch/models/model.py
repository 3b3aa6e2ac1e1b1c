"""Full model: embedding -> blocks -> norm -> head, for inference.

The port of `repro.models.model`'s serving surface. `LM` is an
`nn.Module` holding, in order: the embedding (scaled by sqrt(d) on
lookup), an `nn.ModuleList` of `repeat` x `pattern` blocks, the final
norm, and the tied or untied head over `padded_vocab`. Where the
reference scans one stacked parameter tree over `repeat`, the port keeps
one module per layer (`convert.params_from_jax` splits the stacked axis).

  embed_inputs -- token ids through the scaled embedding, or, for the
                  `frames` frontend (hubert), the batch's precomputed
                  frame embeddings (B,S,d) as they are;
  prefill      -- forward over a prompt, last-position logits in f32; the
                  path that reaches the flash-attention and SSD kernels;
  decode_step  -- one token against per-layer KV / SSM caches (no kernel);
                  an encoder (`frames`) has none and raises;
  init_cache / cache_len -- the caches, ring-sized for windowed layers.

An FFN is dense SwiGLU, or MoE (`models.moe`, one token group, as the
reference runs without a mesh); serving drops the MoE's aux loss. A
`frames` model still declares `embed` (and an untied `lm_head`), as the
reference does.

Not ported yet (ROADMAP Queue 1 item 11): the training surface
(`train_loss`, `chunked_ce`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, mamba, moe
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import (DTYPES, DeclModule, ParamDecl,
                                       init_module, rms_norm, swiglu)


def _ffn_decls(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDecl((d, f), ("embed", "mlp")),
        "w_in": ParamDecl((d, f), ("embed", "mlp")),
        "w_out": ParamDecl((f, d), ("mlp", "embed")),
    }


class Block(nn.Module):
    """One layer: norm1 -> attention or mamba -> residual, then (if the
    pattern says so) norm2 -> SwiGLU or MoE FFN -> residual."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.spec = spec
        norm = {"norm1": ParamDecl((cfg.d_model,), (None,), init="zeros")}
        if spec.has_ffn:
            norm["norm2"] = ParamDecl((cfg.d_model,), (None,), init="zeros")
        self.norms = DeclModule(norm, dtype, device)
        if spec.kind == "attn":
            self.attn = attention.Attention(cfg, dtype, device)
        else:
            self.mamba = mamba.Mamba(cfg, dtype, device)
        if spec.has_ffn:
            self.ffn = DeclModule(
                moe.decls(cfg) if spec.moe else _ffn_decls(cfg), dtype,
                device)


def _ffn(blk: Block, h, cfg: ModelConfig):
    if blk.spec.moe:
        return moe.apply(blk.ffn, h, cfg)[0]
    return swiglu(h, blk.ffn["w_gate"], blk.ffn["w_in"], blk.ffn["w_out"])


class LM(nn.Module):
    """The language model's parameters (allocated, not initialised: see
    `init_params`)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device, "LM")
        dtype = DTYPES[cfg.param_dtype]
        head = {"embed": ParamDecl((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"), init="embed",
                                   scale=1.0)}
        if not cfg.tie_embeddings:
            head["lm_head"] = ParamDecl((cfg.padded_vocab, cfg.d_model),
                                        ("vocab", "embed"))
        self.embedding = DeclModule(head, dtype, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, spec, dtype, dev)
            for _ in range(cfg.repeat) for spec in cfg.pattern)
        self.final = DeclModule(
            {"final_norm": ParamDecl((cfg.d_model,), (None,),
                                     init="zeros")}, dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embedding["embed"].device

    def head_weights(self) -> torch.Tensor:
        e = self.embedding
        return e["lm_head"] if "lm_head" in e.decls else e["embed"]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """An `LM` with random weights from a seeded `torch.Generator` on
    `device` (default: the CUDA device; raises without one)."""
    model = LM(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return init_module(model, gen)


# --------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------- #
def _run_block(blk: Block, x, cfg: ModelConfig):
    spec = blk.spec
    h = rms_norm(x, blk.norms["norm1"], cfg.rms_eps)
    if spec.kind == "attn":
        a, _ = attention.apply(blk.attn, h, cfg, spec.window)
    else:
        a = mamba.apply(blk.mamba, h, cfg)
    x = x + a
    if spec.has_ffn:
        x = x + _ffn(blk, rms_norm(x, blk.norms["norm2"], cfg.rms_eps), cfg)
    return x


def backbone(params: LM, x, cfg: ModelConfig):
    """x: (B,S,d) embeddings -> hidden (B,S,d) after the final norm."""
    for blk in params.blocks:
        x = _run_block(blk, x, cfg)
    return rms_norm(x, params.final["final_norm"], cfg.rms_eps)


def embed_tokens(params: LM, tokens, cfg: ModelConfig):
    act = DTYPES[cfg.activation_dtype]
    emb = params.embedding["embed"][tokens]
    return (emb.float() * math.sqrt(cfg.d_model)).to(act)


def embed_inputs(params: LM, batch: dict, cfg: ModelConfig):
    """batch["frames"] (B,S,d) in the activation dtype for the `frames`
    frontend, else batch["tokens"] (B,S) through `embed_tokens`."""
    if cfg.frontend == "frames":
        return batch["frames"].to(DTYPES[cfg.activation_dtype])
    return embed_tokens(params, batch["tokens"], cfg)


@torch.no_grad()
def prefill(params: LM, batch: dict, cfg: ModelConfig):
    """Forward pass over batch["tokens"] (B,S), or batch["frames"]
    (B,S,d) for the `frames` frontend, returning the last position's
    logits (B,1,padded_vocab) in f32."""
    x = embed_inputs(params, batch, cfg)
    hidden = backbone(params, x, cfg)
    last = hidden[:, -1:]
    return (last @ params.head_weights().T).float()


# --------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------- #
def cache_len(cfg: ModelConfig, spec: BlockSpec, max_seq: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """Zero caches, one dict per layer: {"k", "v"} (B, T, KH, hd) for
    attention, {"conv_x", "conv_B", "conv_C", "ssm"} for mamba."""
    dev = resolve_device(device, "init_cache")
    act = DTYPES[cfg.activation_dtype]
    cache = []
    for _ in range(cfg.repeat):
        for spec in cfg.pattern:
            if spec.kind == "attn":
                shape = (batch, cache_len(cfg, spec, max_seq),
                         cfg.num_kv_heads, cfg.head_dim)
                cache.append({"k": torch.zeros(shape, dtype=act, device=dev),
                              "v": torch.zeros(shape, dtype=act,
                                               device=dev)})
            else:
                cache.append(mamba.init_cache(cfg, batch, act, dev))
    return cache


@torch.no_grad()
def decode_step(params: LM, cache: list[dict], tokens, pos,
                cfg: ModelConfig):
    """One serving step. tokens: (B,1) int; pos: (B,) int positions.

    Returns (logits (B,1,padded_vocab) f32, new cache). Attention caches
    are updated in place (see `attention.decode`); mamba states are
    replaced. Raises ValueError for an encoder (`frames` frontend)."""
    if cfg.frontend == "frames":
        raise ValueError("encoder models have no decode step")
    x = embed_tokens(params, tokens, cfg)
    new_cache = []
    for blk, c in zip(params.blocks, cache):
        spec = blk.spec
        h = rms_norm(x, blk.norms["norm1"], cfg.rms_eps)
        if spec.kind == "attn":
            a, (ck, cv) = attention.decode(blk.attn, h, c["k"], c["v"], pos,
                                           cfg, spec.window)
            new_cache.append({"k": ck, "v": cv})
        else:
            a, nc = mamba.decode(blk.mamba, h, c, cfg)
            new_cache.append(nc)
        x = x + a
        if spec.has_ffn:
            x = x + _ffn(blk, rms_norm(x, blk.norms["norm2"], cfg.rms_eps),
                         cfg)
    x = rms_norm(x, params.final["final_norm"], cfg.rms_eps)
    return (x @ params.head_weights().T).float(), new_cache
