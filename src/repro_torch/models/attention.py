"""GQA attention: prefill over the full sequence, and single-token decode.

The port of `repro.models.attention`. The full-sequence attention is
`kernels.attention.ops.flash_attention`: the hand-written flash kernel on
CUDA tensors (K2's custom ops, whose fake implementations and FLOP
formulas the dry-run reads on meta and fake tensors), its plain version
(`attention_ref`) on CPU tensors. Under a device mesh the projections are
DTensor products, and the qk-norm, RoPE and the kernel run in one
`local_map` region on each rank's shard: batch over the data axes, heads
over `model` (the placements of the reference's `constrain` calls at
`attention.py:193-197`), so K2 and its backward see plain local tensors
and need no communication. The reference's `lax_flash` has no
counterpart: it is the XLA stand-in its dry-run needs, and the port's
dry-run counts K2 by its FLOP formula instead.

Decode attends one query over a KV cache (einsum + softmax, no kernel);
sliding-window layers keep a ring cache of length `window`. Under a mesh
the cache's T axis is split over `kv_seq` (`long_kv_seq` for long
contexts), the rank holding a row's slot writes it, and the softmax's max
and sums over T are combined across the ranks that split T (the
flash-decoding layout: `_decode_sharded`).

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


def _model_dim(w) -> int | None:
    """The dim of a weight DTensor that the `model` axis splits (None
    when it splits none)."""
    mesh = w.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return None
    pl = w.placements[mesh.mesh_dim_names.index("model")]
    return pl.dim if isinstance(pl, sh.Shard) else None


def _weight_placements(w, dim: int | None) -> tuple:
    """`w` whole over every mesh axis but `model`, and split over `model`
    on `dim` (as it is placed)."""
    names = w.device_mesh.mesh_dim_names
    return tuple(sh.Shard(dim) if a == "model" and dim is not None
                 else sh.Replicate() for a in names)


def _project_sharded(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` under a mesh, in a `local_map`
    region: x with batch over the data axes, the weight gathered over
    them (its FSDP shards) and split over `model` as it is placed (heads,
    or head_dim where the heads do not divide: DTensor's own einsum views
    (h, hd) as one dim, a strided split its product cannot take). The
    result is split over `model` on the same dim."""
    mesh = w.device_mesh
    dim = _model_dim(w)
    xpl = sh.activation_placements(x.shape, "batch", None, None)
    opl = tuple(sh.Shard(dim + 1) if a == "model" and dim is not None
                else pl for a, pl in zip(mesh.mesh_dim_names, xpl))
    return sh.local_region(
        lambda x, w: torch.einsum("bsd,dhk->bshk", x, w), opl,
        (xpl, _weight_placements(w, dim)), mesh,
        tuple(x.shape[:2]) + tuple(w.shape[1:]))(x, w)


def _out_sharded(o, wo):
    """``einsum("bshk,hkd->bsd", o, wo)`` under a mesh, in a `local_map`
    region: o split over `model` on the dim that splits wo's (h, hd), so
    each rank's product is its share of the sum (`Partial` over
    `model`), batch over the data axes."""
    mesh = wo.device_mesh
    dim = _model_dim(wo)
    base = sh.activation_placements(o.shape, "batch", None, None, None)
    split = [a == "model" and dim is not None for a in mesh.mesh_dim_names]
    opl = tuple(sh.Shard(dim + 2) if sp else pl
                for sp, pl in zip(split, base))
    out = tuple(sh.Partial() if sp else pl for sp, pl in zip(split, base))
    return sh.local_region(
        lambda o, w: torch.einsum("bshk,hkd->bsd", o, w), out,
        (opl, _weight_placements(wo, dim)), mesh,
        tuple(o.shape[:2]) + (wo.shape[2],))(o, wo)


def _attend_seq(q, k, v, q_norm, k_norm, cfg: ModelConfig,
                window: int | None, kv_heads=None):
    """qk-norm, RoPE over positions 0..S-1 and attention, on the heads it
    is given. `kv_heads` (a slice, or one index per query head) picks the
    key/value heads of these query heads when k/v arrive whole (a rank's
    share of a replicated KV)."""
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
    heads of its query heads (`torch.chunk`'s split, as DTensor's): whole
    GQA groups where its query heads form them, else one KV head per
    query head (phi3's 40 heads in groups of 4 over 16 ranks)."""
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
                n = min(c, h - off)
                try:
                    kv_heads = _local_kv_heads(h, kh, n, off)
                except ValueError:
                    # no whole groups: each query head gets its own copy
                    # of its KV head (the reference's `_expand_kv` gather)
                    kv_heads = [(off + i) // (h // kh) for i in range(n)]
    rep = (sh.Replicate(),) * mesh.ndim
    norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    norm_pl = tuple(None if n is None else rep for n in norms)

    def local(q, k, v, qn, kn):
        if q.shape[2] == 0:             # a rank past the last head
            return q.new_empty(q.shape)
        return _attend_seq(q, k, v, qn, kn, cfg, window, kv_heads)
    return sh.local_region(local, qpl, (qpl, kpl, kpl) + norm_pl, mesh,
                           q.shape)(q, k, v, *norms)


def apply(p, x, cfg: ModelConfig, window: int | None):
    """Prefill self-attention over the full sequence. x: (B,S,d).
    Returns (out (B,S,d), (k, v)) so prefill can keep the cache (k after
    the projection, before qk-norm and RoPE, under a mesh)."""
    x = sh.constrain(x, "batch", None, None)
    if sh.current_mesh() is not None:
        q, k, v = (_project_sharded(x, p[n]) for n in ("wq", "wk", "wv"))
        q = sh.constrain(q, "batch", None, "act_heads", None)
        k = sh.constrain(k, "batch", None, "act_heads", None)
        v = sh.constrain(v, "batch", None, "act_heads", None)
        o = _attend_sharded(q, k, v, p, cfg, window)
        o = sh.constrain(o, "batch", None, "act_heads", None)
        return _out_sharded(o, p["wo"]), (k, v)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attend(q, k, v, causal=cfg.causal, window=window)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, (k, v)


def _write_slot(cache, new, slot, lo: int):
    """Write `new` (B,1,K,hd) into row b's slot `slot[b]` of a cache
    slice whose slots are ``lo .. lo + T_loc - 1``, in place; a row whose
    slot lies in another rank's slice rewrites its own value."""
    t_loc = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    mine = (slot >= lo) & (slot < lo + t_loc)
    local = torch.clamp(slot - lo, 0, t_loc - 1)
    cache[rows, local] = torch.where(mine[:, None, None],
                                     new[:, 0].to(cache.dtype),
                                     cache[rows, local])


def _scores(q, cache_k, pos, cfg: ModelConfig, window: int | None,
            ring: bool, t: int, lo: int = 0):
    """Masked, scaled scores (B,K,G,T_loc) in f32 of one query per row
    over the cache slots ``lo .. lo + T_loc - 1`` of `t`."""
    b, kh = cache_k.shape[0], cache_k.shape[2]
    g = q.shape[2] // kh
    qr = q.reshape(b, kh, g, cfg.head_dim)
    scores = torch.einsum("bkgd,btkd->bkgt", qr, cache_k).float()
    scores = scores / math.sqrt(cfg.head_dim)
    slots = lo + torch.arange(cache_k.shape[1], device=q.device)
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
    return torch.where(ok[:, None, None, :], scores, NEG_INF)


def _attend_cache(q, cache_k, cache_v, pos, cfg: ModelConfig,
                  window: int | None, ring: bool, dtype):
    """One query per row over a whole cache: softmax over every slot, in
    `dtype` for the product with V. Returns (B,1,H,hd)."""
    b = q.shape[0]
    scores = _scores(q, cache_k, pos, cfg, window, ring, cache_k.shape[1])
    pattn = torch.softmax(scores, dim=-1).to(dtype)
    o = torch.einsum("bkgt,btkd->bkgd", pattn, cache_v)
    return o.reshape(b, 1, q.shape[2], cfg.head_dim)


def decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
           window: int | None, long_ctx: bool = False):
    """Single-token decode. x: (B,1,d); cache: (B,T,K,hd); pos: (B,) int.

    Writes the new key and value into the caches IN PLACE (slot `pos`, or
    `pos % window` for a ring cache of length T == window) -- the
    reference rebuilds the cache functionally; writing one slot saves
    rewriting all of it every step -- and returns (out (B,1,d),
    (cache_k, cache_v)). Under a device mesh the caches are DTensors with
    the T axis split by `kv_seq` (`long_kv_seq` with `long_ctx`):
    `_decode_sharded`."""
    b = x.shape[0]
    t = cache_k.shape[1]
    ring = window is not None and t == window
    if sh.current_mesh() is not None:
        o = _decode_sharded(p, x, cache_k, cache_v, pos, cfg, window, ring,
                            long_ctx)
        return _out_sharded(o, p["wo"]), (cache_k, cache_v)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])

    slot = (pos % t) if ring else pos
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    o = _attend_cache(q, cache_k, cache_v, pos, cfg, window, ring, x.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, (cache_k, cache_v)


def _decode_sharded(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
                    window: int | None, ring: bool, long_ctx: bool):
    """`decode` under a mesh, on each rank's slice of the caches as they
    are placed (`launch.steps.cache_shardings`: batch over the data axes,
    T over `kv_seq` / `long_kv_seq`, or KV heads over `model` where T
    does not take it). The projections are DTensor products; qk-norm,
    RoPE, the slot write and the scores run in a `local_map` region,
    where only the rank whose slice holds a row's slot writes it. Where
    no mesh dim splits T, the softmax is the one-device code's on each
    rank. Where T is split (the flash-decoding layout), each rank takes
    its slice's scores and max, the max is combined over the T axes (an
    all-reduce max: `Partial("max")`), then each rank's exp-sum and its
    exp-weighted sum of V (f32) are combined (all-reduce sums) and
    divided. Returns o (B,1,H,hd) in x's dtype."""
    del long_ctx                # the caches' placements carry the T split
    mesh = sh.current_mesh()
    x = sh.constrain(x, "batch", None, None)
    q, k_new, v_new = (_project_sharded(x, p[n]) for n in ("wq", "wk", "wv"))
    t = cache_k.shape[1]
    cpl = tuple(cache_k.placements)
    rep = sh.Replicate()
    # the mesh dims that split T (a size-1 dim splits nothing)
    t_dims = [j for j, pl in enumerate(cpl)
              if pl == sh.Shard(1) and mesh.shape[j] > 1]
    qpl = tuple(pl if pl in (sh.Shard(0), sh.Shard(2)) else rep
                for pl in cpl)
    ppl = tuple(pl if pl == sh.Shard(0) else rep for pl in cpl)
    reps = (rep,) * mesh.ndim
    norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    norm_pl = tuple(None if n is None else reps for n in norms)
    lo, _ = sh.shard_range(t, cpl, mesh, 1)
    dtype = x.dtype

    def prepare(q, kn, vn, qn, knn, pos, ck, cv):
        q, kn = _qk_rotary(q, kn, qn, knn, cfg, pos[:, None])
        slot = (pos % t) if ring else pos
        _write_slot(ck, kn, slot, lo)
        _write_slot(cv, vn, slot, lo)
        return q
    q = sh.local_region(
        prepare, qpl, (qpl, qpl, qpl) + norm_pl + (ppl, cpl, cpl), mesh)(
            q, k_new, v_new, *norms, pos, cache_k, cache_v)
    if not t_dims:
        return sh.local_region(
            lambda q, pos, ck, cv: _attend_cache(q, ck, cv, pos, cfg,
                                                 window, ring, dtype),
            qpl, (qpl, ppl, cpl, cpl), mesh)(q, pos, cache_k, cache_v)

    # scores (B,K,G,T): batch as the cache's, T split as the cache's T
    spl = tuple(sh.Shard(3) if j in t_dims else pl
                for j, pl in enumerate(ppl))
    mpl = tuple(sh.Partial("max") if j in t_dims else pl
                for j, pl in enumerate(ppl))
    psum = tuple(sh.Partial() if j in t_dims else pl
                 for j, pl in enumerate(ppl))

    def local_scores(q, pos, ck):
        sc = _scores(q, ck, pos, cfg, window, ring, t, lo)
        return sc, sc.amax(dim=-1)
    scores, m = sh.local_region(local_scores, (spl, mpl), (qpl, ppl, cpl),
                                mesh)(q, pos, cache_k)
    m = m.redistribute(mesh, ppl)           # the max over every slice

    def local_sums(sc, m, cv):
        pe = torch.exp(sc - m[..., None])
        return pe.sum(-1), torch.einsum("bkgt,btkd->bkgd", pe, cv.float())
    den, num = sh.local_region(local_sums, (psum, psum), (spl, ppl, cpl),
                               mesh)(scores, m, cache_v)
    den, num = den.redistribute(mesh, ppl), num.redistribute(mesh, ppl)
    return sh.local_region(
        lambda num, den: (num / den[..., None]).to(dtype).reshape(
            num.shape[0], 1, -1, cfg.head_dim),
        ppl, (ppl, ppl), mesh)(num, den)
