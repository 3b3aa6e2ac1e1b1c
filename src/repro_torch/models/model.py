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
  decode_step  -- one token against per-layer KV / SSM caches (no kernel),
                  one `superblock_decode` per pattern period; an encoder
                  (`frames`) has none and raises;
  init_cache / cache_len -- the caches, ring-sized for windowed layers;
  superblock, superblock_decls, apply_superblock, superblock_decode --
                  one pattern period (the `len(pattern)` consecutive
                  blocks of `LM.blocks`), the dry-run's component
                  (`launch.dryrun.measure_components`).

Under a device mesh (`distributed.mesh_context`, the parameters and the
batch DTensors: `launch.steps.shard_state`, `shard_batch`) the same code
runs on each rank's shards: `constrain` at the reference's points
(`model.py:99,109,123,158,219,394`) redistributes the activations, and
DTensor's sharding propagation does the rest. Decode runs under a mesh
too, its caches in `cache_logical_axes`' placements (`long_ctx`: T over
`long_kv_seq`; see `attention.decode`). `abstract_params`,
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
                                              local_region, replicated_like,
                                              shard_range)
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


def _ffn(blk: Block, h, cfg: ModelConfig, moe_dispatch: str = "gspmd"):
    """The block's FFN: (y, MoE aux loss, or None for a dense FFN)."""
    if blk.spec.moe:
        return moe.apply(blk.ffn, h, cfg, dispatch=moe_dispatch)
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
def _run_block(blk: Block, x, cfg: ModelConfig,
               moe_dispatch: str = "gspmd"):
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
                          cfg, moe_dispatch)
        x = x + constrain(f, "batch", "seq", None)
        x = constrain(x, "batch", "seq", None)
        if moe_aux is not None:
            aux = moe_aux
    return x, aux


def backbone(params: LM, x, cfg: ModelConfig, remat: bool = True,
             moe_dispatch: str = "gspmd"):
    """x: (B,S,d) embeddings -> (hidden (B,S,d) after the final norm, aux
    loss scalar). With `remat`, each block is one non-reentrant checkpoint:
    its input is saved and its internals are recomputed in the backward,
    so the live set is one layer plus every block's input."""
    x = constrain(x, "batch", "seq", None)
    aux = replicated_like(x, torch.zeros((), dtype=torch.float32,
                                         device=x.device))
    for blk in params.blocks:
        x, a = _block(blk, x, cfg, moe_dispatch, remat)
        aux = aux + a
    return rms_norm(x, params.final["final_norm"], cfg.rms_eps), aux


def _block(blk: Block, x, cfg: ModelConfig, moe_dispatch: str, remat: bool):
    if remat:
        return checkpoint(_run_block, blk, x, cfg, moe_dispatch,
                          use_reentrant=False, preserve_rng_state=False)
    return _run_block(blk, x, cfg, moe_dispatch)


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
    return local_region(local, out, (tpl, wpl), mesh,
                        tuple(tokens.shape) + (w.shape[1],))(tokens, w)


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
    label's logit. Under a mesh both terms are vocab-parallel
    (`_ce_sharded`)."""
    logits = torch.einsum("bsd,vd->bsv", h_c, w).float()
    logits = constrain(logits, "batch", None, "act_vocab")
    if current_mesh() is not None:
        return _ce_sharded(logits, constrain(y_c, "batch", None))
    lse = torch.logsumexp(logits, dim=-1)
    lbl = logits.gather(-1, y_c[..., None].long())[..., 0]
    return (lse - lbl).sum()


def _ce_sharded(logits, y):
    """The chunk's loss on vocab-split logits (Megatron's vocab-parallel
    cross-entropy), in `local_map` regions over each rank's slice: the
    row max (combined by an all-reduce max, `Partial("max")`), the sum of
    exp(logit - max) and the label's logit where this rank's slice holds
    the label (zero elsewhere; both combined by all-reduce sums); log-sum-
    exp = max + log(sum), as `torch.logsumexp` computes it. No rank holds
    a whole row of logits. The max is a constant to the gradient."""
    mesh = current_mesh()
    lpl = tuple(logits.placements)
    rep = Replicate()
    split = [j for j, p in enumerate(lpl) if p == Shard(2)]
    rpl = tuple(p if p == Shard(0) else rep for p in lpl)     # per row
    mx = tuple(Partial("max") if j in split else p
               for j, p in enumerate(rpl))
    sums = tuple(Partial() if j in split else p for j, p in enumerate(rpl))
    lo, _ = shard_range(logits.shape[2], lpl, mesh, 2)
    rows = tuple(y.shape)
    m = local_region(lambda lg: lg.amax(dim=-1), mx, (lpl,), mesh, rows)(
        logits).redistribute(mesh, rpl).detach()

    def local(lg, m, y):
        ids = y.long() - lo
        mine = (ids >= 0) & (ids < lg.shape[2])
        lbl = lg.gather(-1, torch.where(mine, ids, 0)[..., None])[..., 0]
        return (torch.exp(lg - m[..., None]).sum(-1),
                torch.where(mine, lbl, 0.0))
    total, lbl = local_region(local, (sums, sums), (lpl, rpl, rpl), mesh,
                              (rows, rows))(logits, m, y)
    lse = torch.log(total.redistribute(mesh, rpl)) + m
    return (lse - lbl.redistribute(mesh, rpl)).sum()


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
    if current_mesh() is not None:
        # the head's FSDP shards gathered once for every chunk (rows stay
        # split over the vocab axes): left to DTensor, each chunk's product
        # gathers the activations' batch instead and reduce-scatters
        # partial logits, 16x the bytes at (16, 16)
        w = w.redistribute(w.device_mesh, tuple(
            p if p == Shard(0) else Replicate() for p in w.placements))
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
               remat: bool = True, moe_dispatch: str = "gspmd"):
    """``chunked_ce + AUX_WEIGHT * aux`` over batch["tokens"] (or
    ["frames"]) and batch["labels"] (B,S)."""
    x = embed_inputs(params, batch, cfg)
    hidden, aux = backbone(params, x, cfg, remat=remat,
                           moe_dispatch=moe_dispatch)
    ce = chunked_ce(params, hidden, batch["labels"], cfg)
    return ce + AUX_WEIGHT * aux


def head_loss(params: LM, hidden, labels, cfg: ModelConfig,
              scan_chunks: bool = True):
    """Final norm + CE (the non-repeated tail of the train step).
    `scan_chunks` is the reference's choice between a scanned and an
    unrolled chunk loop; the port's loop is a Python loop either way (the
    reference's unrolled form), so it changes nothing."""
    del scan_chunks
    h = rms_norm(hidden, params.final["final_norm"], cfg.rms_eps)
    return chunked_ce(params, h, labels, cfg)


@torch.no_grad()
def prefill(params: LM, batch: dict, cfg: ModelConfig,
            moe_dispatch: str = "gspmd"):
    """Forward pass over batch["tokens"] (B,S), or batch["frames"]
    (B,S,d) for the `frames` frontend, returning the last position's
    logits (B,1,padded_vocab) in f32."""
    x = embed_inputs(params, batch, cfg)
    hidden, _ = backbone(params, x, cfg, remat=False,
                         moe_dispatch=moe_dispatch)
    last = hidden[:, -1:]
    logits = (last @ params.head_weights().T).float()
    return constrain(logits, "batch", None, "act_vocab")


# --------------------------------------------------------------------- #
# one pattern period (the dry-run's component measurement)
# --------------------------------------------------------------------- #
def superblock_decls(cfg: ModelConfig) -> dict:
    """{name within one period's blocks: ParamDecl}, the names being those
    of `superblock(cfg)`'s parameters ("0.attn.wq", ...; the reference's
    `superblock_decls`, which keys them "block0/attn/wq", ...)."""
    out = {}
    for prefix, mod in superblock(cfg, "meta").named_modules():
        if isinstance(mod, DeclModule):
            for name, decl in mod.decls.items():
                out[f"{prefix}.{name}"] = decl
    return out


def superblock(cfg: ModelConfig, device=None) -> nn.ModuleList:
    """One pattern period: `len(cfg.pattern)` blocks, as `LM.blocks`
    holds them `repeat` times (parameters allocated, not initialised)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(
        device, "superblock")
    dtype = DTYPES[cfg.param_dtype]
    return nn.ModuleList(Block(cfg, spec, dtype, dev) for spec in cfg.pattern)


def apply_superblock(blocks, x, cfg: ModelConfig,
                     moe_dispatch: str = "gspmd", remat: bool = True):
    """One period's blocks (`len(cfg.pattern)` consecutive `Block`s, e.g.
    ``params.blocks[i * P:(i + 1) * P]``) over x (B,S,d), as `backbone`
    runs them (one checkpoint per block with `remat`). Returns (x, aux).
    The reference's `impl` has no counterpart: the tensors' device picks
    the attention route."""
    aux = replicated_like(x, torch.zeros((), dtype=torch.float32,
                                         device=x.device))
    for blk in blocks:
        x, a = _block(blk, x, cfg, moe_dispatch, remat)
        aux = aux + a
    return x, aux


def superblock_decode(blocks, caches: list, x, pos, cfg: ModelConfig,
                      long_ctx: bool = False, moe_dispatch: str = "gspmd"):
    """One period's blocks for one token: x (B,1,d), `caches` their
    per-layer caches (attention caches written in place). Returns (x,
    new caches). Drops the MoE's aux loss, as serving does."""
    new_caches = []
    for blk, c in zip(blocks, caches):
        spec = blk.spec
        h = rms_norm(x, blk.norms["norm1"], cfg.rms_eps)
        if spec.kind == "attn":
            a, (ck, cv) = attention.decode(blk.attn, h, c["k"], c["v"], pos,
                                           cfg, spec.window, long_ctx)
            new_caches.append({"k": ck, "v": cv})
        else:
            a, nc = mamba.decode(blk.mamba, h, c, cfg)
            new_caches.append(nc)
        x = constrain(x + a, "batch", None, None)
        if spec.has_ffn:
            f, _ = _ffn(blk, rms_norm(x, blk.norms["norm2"], cfg.rms_eps),
                        cfg, moe_dispatch)
            x = constrain(x + f, "batch", None, None)
    return x, new_caches


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
    `init_cache`): no allocation. As in the reference, `long_ctx` leaves
    the structure as it is: a long context's caches differ only in their
    logical axes (`cache_logical_axes`: T over `long_kv_seq`), which decide
    how a mesh splits them."""
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
               long_ctx: bool = False, device=None) -> list[dict]:
    """Zero caches, one dict per layer: {"k", "v"} (B, T, KH, hd) for
    attention, {"conv_x", "conv_B", "conv_C", "ssm"} for mamba. The
    structure of `abstract_cache(cfg, batch, max_seq, long_ctx)`."""
    dev = resolve_device(device, "init_cache")
    return [{k: torch.zeros(a.shape, dtype=a.dtype, device=dev)
             for k, a in layer.items()}
            for layer in abstract_cache(cfg, batch, max_seq, long_ctx)]


@torch.no_grad()
def decode_step(params: LM, cache: list[dict], tokens, pos,
                cfg: ModelConfig, long_ctx: bool = False,
                moe_dispatch: str = "gspmd"):
    """One serving step. tokens: (B,1) int; pos: (B,) int positions.

    Returns (logits (B,1,padded_vocab) f32, new cache). Attention caches
    are updated in place (see `attention.decode`); mamba states are
    replaced. Each pattern period is one `superblock_decode`. Under a
    device mesh the caches are DTensors in `cache_logical_axes`'
    placements (`long_ctx`: T over `long_kv_seq`). Raises ValueError for
    an encoder (`frames` frontend)."""
    if cfg.frontend == "frames":
        raise ValueError("encoder models have no decode step")
    x = embed_tokens(params, tokens, cfg)
    p = len(cfg.pattern)
    new_cache = []
    for i in range(cfg.repeat):
        sl = slice(i * p, (i + 1) * p)
        x, nc = superblock_decode(params.blocks[sl], cache[sl], x, pos, cfg,
                                  long_ctx, moe_dispatch)
        new_cache += nc
    x = rms_norm(x, params.final["final_norm"], cfg.rms_eps)
    logits = (x @ params.head_weights().T).float()
    return constrain(logits, "batch", None, "act_vocab"), new_cache
