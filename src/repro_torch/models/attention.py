"""GQA attention: prefill over the full sequence, and single-token decode.

The port of `repro.models.attention`. The full-sequence attention is
`kernels.attention.ops.flash_attention`: the hand-written flash kernel on
CUDA tensors, its plain version (`attention_ref`) on CPU tensors. Under a
device mesh the projections are DTensor products, and the qk-norm, RoPE
and the kernel run in one `local_map` region on each rank's shard: batch
over the data axes, heads over `model` (the placements of the reference's
`constrain` calls at `attention.py:193-197`), so K2 and its backward see
plain local tensors and need no communication. The
reference's `lax_flash` has no counterpart: it is the XLA stand-in its
multi-pod dry-run needs. Decode attends one query over a KV cache
(einsum + softmax, no kernel); sliding-window layers keep a ring cache of
length `window`.

Layouts are the reference's: wq (d, h, hd), wk/wv (d, kh, hd),
wo (h, hd, d); activations (B, S, H, hd).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DeclModule, ParamDecl, rms_norm, rotary

NEG_INF = -1e30


def decls(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {
        "wq": ParamDecl((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDecl((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDecl((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDecl((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDecl((hd,), (None,), init="zeros")
        out["k_norm"] = ParamDecl((hd,), (None,), init="zeros")
    return out


class Attention(DeclModule):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(decls(cfg), dtype, device)


def attend(q, k, v, causal: bool, window: int | None):
    """Full-sequence attention. q: (B,S,H,hd); k/v: (B,T,KH,hd). The
    tensors' device picks the route (`flash_attention`)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


# --------------------------------------------------------------------- #
# layer entry points
# --------------------------------------------------------------------- #
def _qk_rotary(q, k, q_norm, k_norm, cfg: ModelConfig, positions):
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.rms_eps)
        k = rms_norm(k, k_norm, cfg.rms_eps)
    return rotary(q, k, positions, cfg.rope_theta)


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q, k = _qk_rotary(q, k, p["q_norm"] if cfg.qk_norm else None,
                      p["k_norm"] if cfg.qk_norm else None, cfg, positions)
    return q, k, v


def _attend_seq(q, k, v, q_norm, k_norm, cfg: ModelConfig,
                window: int | None, kv_heads: slice | None = None):
    """qk-norm, RoPE over positions 0..S-1 and attention, on the heads it
    is given. `kv_heads` picks the key/value heads of these query heads
    when k/v arrive whole (a rank's share of a replicated KV)."""
    b, s = q.shape[:2]
    if kv_heads is not None:
        k, v = k[:, :, kv_heads], v[:, :, kv_heads]
    positions = torch.arange(s, device=q.device).expand(b, s)
    q, k = _qk_rotary(q, k, q_norm, k_norm, cfg, positions)
    return attend(q, k, v, causal=cfg.causal, window=window)


def _local_kv_heads(h: int, kh: int, h_loc: int, offset: int) -> slice:
    """The KV heads of query heads [offset, offset + h_loc) under GQA
    (h // kh queries per KV head); raises when they do not form whole
    local groups."""
    g = h // kh
    if offset % g == 0 and h_loc % g == 0:
        return slice(offset // g, (offset + h_loc) // g)
    if g % h_loc == 0 and offset % h_loc == 0:
        return slice(offset // g, offset // g + 1)
    raise ValueError(
        f"query heads {offset}..{offset + h_loc - 1} of {h} do not form "
        f"whole GQA groups of {g}: no KV head split serves this rank")


def _attend_sharded(q, k, v, p, cfg: ModelConfig, window: int | None):
    """`_attend_seq` in a `local_map` region: q/k/v with batch over the
    data axes and heads over `model`. Where the model axis does not
    divide both head counts, k/v arrive whole and each rank takes the KV
    heads of its query heads (`torch.chunk`'s split, as DTensor's)."""
    mesh = sh.current_mesh()
    h, kh = q.shape[2], k.shape[2]
    qpl = sh.activation_placements(q.shape, "batch", None, "act_heads",
                                   None)
    kpl, kv_heads = qpl, None
    names = mesh.mesh_dim_names
    if "model" in names and isinstance(qpl[names.index("model")], sh.Shard):
        m = names.index("model")
        size = mesh.shape[m]
        if h % size or kh % size:
            kpl = qpl[:m] + (sh.Replicate(),) + qpl[m + 1:]
            c = -(-h // size)
            off = min(mesh.get_coordinate()[m] * c, h)
            if off < h:
                kv_heads = _local_kv_heads(h, kh, min(c, h - off), off)
    rep = (sh.Replicate(),) * mesh.ndim
    norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    norm_pl = tuple(None if n is None else rep for n in norms)

    def local(q, k, v, qn, kn):
        if q.shape[2] == 0:             # a rank past the last head
            return q.new_empty(q.shape)
        return _attend_seq(q, k, v, qn, kn, cfg, window, kv_heads)
    return sh.local_region(local, qpl, (qpl, kpl, kpl) + norm_pl,
                           mesh)(q, k, v, *norms)


def apply(p, x, cfg: ModelConfig, window: int | None):
    """Prefill self-attention over the full sequence. x: (B,S,d).
    Returns (out (B,S,d), (k, v)) so prefill can keep the cache (k after
    the projection, before qk-norm and RoPE, under a mesh)."""
    x = sh.constrain(x, "batch", None, None)
    if sh.current_mesh() is not None:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        q = sh.constrain(q, "batch", None, "act_heads", None)
        k = sh.constrain(k, "batch", None, "act_heads", None)
        v = sh.constrain(v, "batch", None, "act_heads", None)
        o = _attend_sharded(q, k, v, p, cfg, window)
        o = sh.constrain(o, "batch", None, "act_heads", None)
    else:
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = _project_qkv(p, x, cfg, positions)
        o = attend(q, k, v, causal=cfg.causal, window=window)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, (k, v)


def decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
           window: int | None):
    """Single-token decode. x: (B,1,d); cache: (B,T,K,hd); pos: (B,) int.

    Writes the new key and value into the caches IN PLACE (slot `pos`, or
    `pos % window` for a ring cache of length T == window) -- the
    reference rebuilds the cache functionally; writing one slot saves
    rewriting all of it every step -- and returns (out (B,1,d),
    (cache_k, cache_v))."""
    b = x.shape[0]
    t = cache_k.shape[1]
    ring = window is not None and t == window
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])

    slot = (pos % t) if ring else pos
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    cache_k = sh.constrain(cache_k, "batch", "kv_seq", "kv_heads", None)
    cache_v = sh.constrain(cache_v, "batch", "kv_seq", "kv_heads", None)

    kh = cache_k.shape[2]
    g = cfg.num_heads // kh
    qr = q.reshape(b, kh, g, cfg.head_dim)
    scores = torch.einsum("bkgd,btkd->bkgt", qr, cache_k).float()
    scores = scores / math.sqrt(cfg.head_dim)
    slots = torch.arange(t, device=x.device)
    if ring:
        # absolute position held by each ring slot; all are <= pos and
        # > pos - window by construction, only warmup slots are invalid
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - slots[None],
                                                 t)
        ok = abs_pos >= 0
    else:
        ok = slots[None, :] <= pos[:, None]
        if window is not None:
            ok &= slots[None, :] > (pos[:, None] - window)
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    pattn = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", pattn, cache_v)
    o = o.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, (cache_k, cache_v)
