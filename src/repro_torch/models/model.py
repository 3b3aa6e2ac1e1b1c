"""Full model: embedding -> blocks -> norm -> head, for training and
inference.

The port of `repro.models.model`. `LM` is an
`nn.Module` holding, in order: the embedding (scaled by sqrt(d) on
lookup), an `nn.ModuleList` of `repeat` x `pattern` blocks, the final
norm, and the tied or untied head over `padded_vocab`. Where the
reference scans one stacked parameter tree over `repeat`, the port keeps
one module per layer (`convert.params_from_jax` splits the stacked axis).

  embed_inputs -- token ids through the scaled embedding, or, for the
                  `frames` frontend (hubert), the batch's precomputed
                  frame embeddings (B,S,d) as they are;
  backbone     -- the blocks and the final norm, with one non-reentrant
                  `torch.utils.checkpoint` per block when `remat` (the
                  reference's per-block `jax.checkpoint(nothing_saveable)`);
                  returns the hidden states and the summed MoE aux loss;
  train_loss   -- ``chunked_ce + AUX_WEIGHT * aux``: the cross-entropy in
                  8 sequence chunks, each checkpointed, its log-sum-exp
                  over all `padded_vocab` columns (`ce_chunk_loss`), so the
                  (B,S,V) logits never exist at once; `head_loss` is the
                  final norm and CE alone;
  prefill      -- forward over a prompt, last-position logits in f32; the
                  path that reaches the flash-attention and SSD kernels;
  decode_step  -- one token against per-layer KV / SSM caches (no kernel);
                  an encoder (`frames`) has none and raises;
  init_cache / cache_len -- the caches, ring-sized for windowed layers.

Under a device mesh (`distributed.mesh_context`, the parameters and the
batch DTensors: `launch.steps.shard_state`, `shard_batch`) the same code
runs on each rank's shards: `constrain` at the reference's points
(`model.py:99,109,123,158,219,394`) redistributes the activations, and
DTensor's sharding propagation does the rest. `abstract_params`,
`abstract_cache` and `cache_logical_axes` describe the parameters and
caches without allocating them (meta tensors).

An FFN is dense SwiGLU, or MoE (`models.moe`, G token groups: one without
a mesh, as the reference); serving drops the MoE's aux loss. A
`frames` model still declares `embed` (and an untied `lm_head`), as the
reference does. Parameters are created with ``requires_grad=False``; the
train step (`launch.steps.make_train_step`) turns gradients on.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Partial, Replicate, Shard,
                                              activation_placements,
                                              constrain, current_mesh,
                                              local_region, replicated_like)
from repro_torch.models import attention, mamba, moe
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import (DTYPES, DeclModule, ParamDecl,
                                       init_module, rms_norm, swiglu)

AUX_WEIGHT = 0.01     # load-balance loss weight


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
    """The block's FFN: (y, MoE aux loss, or None for a dense FFN)."""
    if blk.spec.moe:
        return moe.apply(blk.ffn, h, cfg)
    return swiglu(h, blk.ffn["w_gate"], blk.ffn["w_in"],
                  blk.ffn["w_out"]), None


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


def abstract_params(cfg: ModelConfig) -> LM:
    """The `LM` on the meta device: every parameter's shape and dtype, no
    storage (the reference's ShapeDtypeStruct tree)."""
    return LM(cfg, device="meta")


# --------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------- #
def _run_block(blk: Block, x, cfg: ModelConfig):
    """One layer. Returns (x, aux): aux is the MoE's load-balance loss
    (f32 scalar), 0 for a dense FFN or none."""
    spec = blk.spec
    h = rms_norm(x, blk.norms["norm1"], cfg.rms_eps)
    if spec.kind == "attn":
        a, _ = attention.apply(blk.attn, h, cfg, spec.window)
    else:
        a = mamba.apply(blk.mamba, h, cfg)
    # the branch reduce-scattered to the residual's placements before the
    # add, explicitly: an add that redistributes on its own hands the
    # branch a sequence-sharded gradient, which the projection's backward
    # cannot view as (B*S, d)
    x = x + constrain(a, "batch", "seq", None)
    x = constrain(x, "batch", "seq", None)
    aux = replicated_like(x, torch.zeros((), dtype=torch.float32,
                                         device=x.device))
    if spec.has_ffn:
        f, moe_aux = _ffn(blk, rms_norm(x, blk.norms["norm2"], cfg.rms_eps),
                          cfg)
        x = x + constrain(f, "batch", "seq", None)
        x = constrain(x, "batch", "seq", None)
        if moe_aux is not None:
            aux = moe_aux
    return x, aux


def backbone(params: LM, x, cfg: ModelConfig, remat: bool = True):
    """x: (B,S,d) embeddings -> (hidden (B,S,d) after the final norm, aux
    loss scalar). With `remat`, each block is one non-reentrant checkpoint:
    its input is saved and its internals are recomputed in the backward,
    so the live set is one layer plus every block's input."""
    x = constrain(x, "batch", "seq", None)
    aux = replicated_like(x, torch.zeros((), dtype=torch.float32,
                                         device=x.device))
    for blk in params.blocks:
        if remat:
            x, a = checkpoint(_run_block, blk, x, cfg, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _run_block(blk, x, cfg)
        aux = aux + a
    return rms_norm(x, params.final["final_norm"], cfg.rms_eps), aux


def _embed_sharded(tokens, w):
    """The lookup in a `local_map` region, vocab-parallel (Megatron's):
    tokens with batch over the data axes, the table whole over `data` and
    split by rows over the axes that split its vocab; each rank looks up
    the ids in its rows (zeros elsewhere), and the sum over those axes
    (`Partial`) is the lookup. DTensor's own embedding strategy over a
    table split both ways fails on such indices."""
    mesh = current_mesh()
    tpl = activation_placements(tokens.shape, "batch", None)
    wpl = tuple(p if p == Shard(0) else Replicate() for p in w.placements)
    out = tuple(Partial() if wp == Shard(0) else tp
                for wp, tp in zip(wpl, tpl))
    coord = mesh.get_coordinate()
    lo, rows = 0, w.shape[0]
    for j, wp in enumerate(wpl):        # rows: torch.chunk's split
        if wp == Shard(0):
            rows = -(-rows // mesh.shape[j])
            lo += coord[j] * rows

    def local(t, wl):
        ids = t.long() - lo
        mine = (ids >= 0) & (ids < wl.shape[0])
        emb = F.embedding(torch.where(mine, ids, 0), wl)
        return torch.where(mine[..., None], emb, 0)
    return local_region(local, out, (tpl, wpl), mesh)(tokens, w)


def embed_tokens(params: LM, tokens, cfg: ModelConfig):
    act = DTYPES[cfg.activation_dtype]
    w = params.embedding["embed"]
    if current_mesh() is None:
        emb = w[tokens]
    else:
        emb = constrain(_embed_sharded(tokens, w), "batch", "seq", None)
    return (emb.float() * math.sqrt(cfg.d_model)).to(act)


def embed_inputs(params: LM, batch: dict, cfg: ModelConfig):
    """batch["frames"] (B,S,d) in the activation dtype for the `frames`
    frontend, else batch["tokens"] (B,S) through `embed_tokens`."""
    if cfg.frontend == "frames":
        return batch["frames"].to(DTYPES[cfg.activation_dtype])
    return embed_tokens(params, batch["tokens"], cfg)


def ce_chunk_loss(w, h_c, y_c, cfg: ModelConfig):
    """Summed token cross-entropy of one sequence chunk: logits (B,c,V)
    over all `padded_vocab` rows of `w` in f32, log-sum-exp minus the
    label's logit."""
    logits = torch.einsum("bsd,vd->bsv", h_c, w).float()
    logits = constrain(logits, "batch", None, "act_vocab")
    lse = torch.logsumexp(logits, dim=-1)
    # DTensor's gather over a vocab-sharded dim (its MaskPartial) fails on
    # this index shape: the label's logit is read from whole rows
    logits = constrain(logits, "batch", None, None)
    y_c = constrain(y_c, "batch", None)
    lbl = logits.gather(-1, y_c[..., None].long())[..., 0]
    return (lse - lbl).sum()


def chunked_ce(params: LM, hidden, labels, cfg: ModelConfig,
               num_chunks: int = 8):
    """Mean token cross-entropy in `num_chunks` sequence chunks, each a
    non-reentrant checkpoint: a chunk's logits exist only while its loss
    (and, in the backward, its gradient) is computed."""
    b, s, _ = hidden.shape
    num_chunks = min(num_chunks, s)
    if s % num_chunks:
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"{num_chunks} chunks")
    cs = s // num_chunks
    w = params.head_weights()
    # whole sequences, so that the chunks slice no sharded dim
    hidden = constrain(hidden, "batch", None, None)
    labels = constrain(labels, "batch", None)
    total = None
    for i in range(num_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        loss = checkpoint(ce_chunk_loss, w, hidden[:, sl], labels[:, sl],
                          cfg, use_reentrant=False, preserve_rng_state=False)
        total = loss if total is None else total + loss
    return total / (b * s)


def train_loss(params: LM, batch: dict, cfg: ModelConfig,
               remat: bool = True):
    """``chunked_ce + AUX_WEIGHT * aux`` over batch["tokens"] (or
    ["frames"]) and batch["labels"] (B,S)."""
    x = embed_inputs(params, batch, cfg)
    hidden, aux = backbone(params, x, cfg, remat=remat)
    ce = chunked_ce(params, hidden, batch["labels"], cfg)
    return ce + AUX_WEIGHT * aux


def head_loss(params: LM, hidden, labels, cfg: ModelConfig):
    """Final norm + CE (the non-repeated tail of the train step)."""
    h = rms_norm(hidden, params.final["final_norm"], cfg.rms_eps)
    return chunked_ce(params, h, labels, cfg)


@torch.no_grad()
def prefill(params: LM, batch: dict, cfg: ModelConfig):
    """Forward pass over batch["tokens"] (B,S), or batch["frames"]
    (B,S,d) for the `frames` frontend, returning the last position's
    logits (B,1,padded_vocab) in f32."""
    x = embed_inputs(params, batch, cfg)
    hidden, _ = backbone(params, x, cfg, remat=False)
    last = hidden[:, -1:]
    logits = (last @ params.head_weights().T).float()
    return constrain(logits, "batch", None, "act_vocab")


# --------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------- #
def cache_len(cfg: ModelConfig, spec: BlockSpec, max_seq: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_seq)
    return max_seq


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   long_ctx: bool = False) -> list[dict]:
    """The caches as meta tensors, one dict per layer (the structure of
    `init_cache`): no allocation. `long_ctx` changes only the caches'
    logical axes (`cache_logical_axes`)."""
    del long_ctx
    meta = torch.device("meta")
    act = DTYPES[cfg.activation_dtype]
    cache = []
    for _ in range(cfg.repeat):
        for spec in cfg.pattern:
            if spec.kind == "attn":
                shape = (batch, cache_len(cfg, spec, max_seq),
                         cfg.num_kv_heads, cfg.head_dim)
                cache.append({"k": torch.empty(shape, dtype=act,
                                               device=meta),
                              "v": torch.empty(shape, dtype=act,
                                               device=meta)})
            else:
                cache.append(mamba.init_cache(cfg, batch, act, meta))
    return cache


def cache_logical_axes(cfg: ModelConfig, long_ctx: bool = False
                       ) -> list[dict]:
    """Logical axes matching `abstract_cache`'s structure (the
    reference's, without its stacked `layers` axis)."""
    kv_ax = "long_kv_seq" if long_ctx else "kv_seq"
    axes = []
    for _ in range(cfg.repeat):
        for spec in cfg.pattern:
            if spec.kind == "attn":
                a = ("batch", kv_ax, "kv_heads", "head_dim")
                axes.append({"k": a, "v": a})
            else:
                axes.append({"conv_x": ("batch", None, "ssm_inner"),
                             "conv_B": ("batch", None, "state"),
                             "conv_C": ("batch", None, "state"),
                             "ssm": ("batch", "ssm_heads", "state", None)})
    return axes


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """Zero caches, one dict per layer: {"k", "v"} (B, T, KH, hd) for
    attention, {"conv_x", "conv_B", "conv_C", "ssm"} for mamba."""
    dev = resolve_device(device, "init_cache")
    return [{k: torch.zeros(a.shape, dtype=a.dtype, device=dev)
             for k, a in layer.items()}
            for layer in abstract_cache(cfg, batch, max_seq)]


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
                         cfg)[0]
    x = rms_norm(x, params.final["final_norm"], cfg.rms_eps)
    logits = (x @ params.head_weights().T).float()
    return constrain(logits, "batch", None, "act_vocab"), new_cache
