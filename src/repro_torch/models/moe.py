"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, SwiGLU experts.

The port of `repro.models.moe`. Tokens are FLIP's packets and experts its
vertices pinned to compute sites; the router is the Inter-Table.

  * Grouped (`dispatch="gspmd"`, and every call without an expert-parallel
    group): the reference's GShard-style capacity dispatch over G token
    groups (`_num_groups`: the shard-local slabs of the ambient mesh, one
    group without a mesh). Each group routes its tokens, and every
    (token, choice) pair takes a slot of its expert's capacity buffer
    (E, C, d), C the group's own capacity, in token-major order; pairs
    past C are dropped. The buffer is built with one `index_copy_` per
    group, the experts' SwiGLU products are batched matrix products
    (`torch.bmm`, as the reference leaves its einsums to XLA), and the
    combine is a gather. Under a mesh the dispatch and the combine run in
    `local_map` regions over each rank's groups, and the (G, E, C, d)
    buffer is resharded from G-major to E-major between them (GShard's
    all-to-all) for the experts, which run on each rank's E/M experts.
  * Expert-parallel (`dispatch="all_to_all"` with a `torch.distributed`
    group whose size divides E, or under a mesh whose `model` axis does):
    `repro_torch.distributed.moe_ep`, two `all_to_all_single`s around the
    rank's own experts, differentiable (`moe_ep.AllToAll`): training
    takes either dispatch.

`apply` returns ``(y, aux)``: y in x's dtype and the Switch-style
load-balance loss ``E * sum_e f_e * p_e`` over every group (serving drops
it).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.nn import functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDecl

DISPATCHES = ("gspmd", "all_to_all")


def decls(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamDecl((d, e), ("embed", None)),
        "w_gate": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_in": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_out": ParamDecl((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _top_k(logits: torch.Tensor, k: int):
    """(weights (T, k) softmaxed over the k, ids (T, k)) in
    `jax.lax.top_k`'s order: value descending, ties by lower expert id.
    `torch.topk` promises no order among equal values, and the order of
    a token's k ids decides its capacity slots, so a stable sort is
    taken instead."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :k], ids[..., :k]
    return torch.softmax(vals, dim=-1), ids


def _capacity(tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(math.ceil(tokens * k * factor / num_experts))
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference does


def expert_counts(flat_ids: torch.Tensor, e: int) -> torch.Tensor:
    """How many entries of `flat_ids` name each of the `e` experts
    (int64). A scatter-add, not `torch.bincount`: its output's length is
    `e` whatever the data, so the dry-run's fake tensors take it."""
    return torch.zeros(e, dtype=torch.int64, device=flat_ids.device) \
        .scatter_add_(0, flat_ids, torch.ones_like(flat_ids))


def _positions_in_expert(flat_ids: torch.Tensor, e: int) -> torch.Tensor:
    """Slot of each (token, choice) within its expert's capacity buffer:
    the number of earlier pairs routed to the same expert. The reference
    takes it from a (T*k, E) one-hot cumsum; a cumsum down a 40-column
    int64 matrix is one slow outer-dim scan on the card (~50 ms per layer
    at 131,072 pairs), so the port ranks each pair within its expert by
    one stable sort, which gives the same slots."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = expert_counts(flat_ids, e)
    starts = counts.cumsum(dim=0) - counts
    pos = torch.empty_like(flat_ids)
    pos[order] = (torch.arange(n, device=flat_ids.device)
                  - starts[flat_ids[order]])
    return pos


def dispatch_buffer(xt: torch.Tensor, ids: torch.Tensor, cap: int, e: int):
    """The capacity buffer (E, C, d) of one token group and the slot map.

    xt: (T, d) tokens; ids: (T, k) routed experts. Pair j = t*k + i goes
    to row ``lin[j] = ids[t, i] * C + slot`` of the flattened buffer when
    its slot is below C (``keep[j]``); a dropped pair is written to a
    spare row past the buffer, so the whole dispatch is one
    `index_copy_` with no host read. Returns ``(buf (E, C, d), lin (T*k,),
    keep (T*k,))``."""
    t, d = xt.shape
    k = ids.shape[1]
    flat = ids.reshape(-1)
    pos = _positions_in_expert(flat, e)
    keep = pos < cap
    lin = torch.where(keep, flat * cap + pos, e * cap)
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, lin, xt.repeat_interleave(k, dim=0))
    return buf[:e * cap].view(e, cap, d), lin, keep


def combine(out: torch.Tensor, lin: torch.Tensor, keep: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """The inverse of the dispatch, a gather: token t's output is the
    weighted sum over its k kept slots. out: (E, C, d); weights (T, k).
    Returns (T, d) in out's dtype."""
    e, cap, d = out.shape
    g = out.reshape(e * cap, d)[torch.where(keep, lin, 0)]
    g = torch.where(keep[:, None], g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
    t, k = weights.shape
    return (g.view(t, k, d) * weights.to(out.dtype)[:, :, None]).sum(dim=1)


def expert_ffn(h: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU. h: (E, C, d); w_gate/w_in (E, d, f); w_out
    (E, f, d). Returns (E, C, d)."""
    return torch.bmm(F.silu(torch.bmm(h, w_gate)) * torch.bmm(h, w_in),
                     w_out)


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits in f32 (the product in the activations' dtype, as
    the reference's einsum) and the top-k weights and ids."""
    logits = (xt @ router).float()
    weights, ids = _top_k(logits, k)
    return logits, weights, ids


def apply(p, x: torch.Tensor, cfg: ModelConfig, dispatch: str = "gspmd",
          group=None):
    """x: (B, S, d). Returns (y (B, S, d) in x's dtype, aux loss).

    `p` holds `decls(cfg)`'s tensors (a module or a dict) with every
    expert. With ``dispatch="all_to_all"`` and a process group whose size
    divides E (`group`, else the ambient mesh's `model` axis), each rank
    routes its own tokens to the experts of every rank
    (`moe_ep.moe_all_to_all`, on this rank's shard of p); otherwise the
    grouped dispatch runs (`_dispatch_gspmd`)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    e = cfg.num_experts
    mesh = sh.current_mesh()
    if dispatch == "all_to_all" and group is None and mesh is not None \
            and "model" in mesh.mesh_dim_names \
            and e % sh.mesh_sizes(mesh)["model"] == 0:
        return _all_to_all_sharded(p, x, cfg)
    if dispatch == "all_to_all" and group is not None \
            and e % dist.get_world_size(group) == 0:
        from repro_torch.distributed.moe_ep import (moe_all_to_all,
                                                    shard_experts)
        y, aux = moe_all_to_all(
            shard_experts(p, dist.get_rank(group),
                          dist.get_world_size(group)), x, cfg, group)
        return y.to(x.dtype), aux
    y, aux = _dispatch_gspmd(p, x, cfg)
    return y.to(x.dtype), aux


# --------------------------------------------------------------------- #
# GShard-style grouped dispatch
# --------------------------------------------------------------------- #
def _num_groups(b: int, s: int) -> tuple[int, int]:
    """Token groups = shard-local slabs: (batch shards) x (seq shards) of
    the ambient mesh, (1, 1) without one. Slots and capacities are
    computed per group, so the dispatch never crosses ranks."""
    mesh = sh.current_mesh()
    if mesh is None:
        return 1, 1
    sizes = sh.mesh_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    nm = sizes.get("model", 1)
    gb = dp if b % dp == 0 else 1
    gs = nm if s % nm == 0 else 1
    return gb, gs


def _to_groups(x: torch.Tensor, gb: int, gs: int) -> torch.Tensor:
    """(B, S, d) -> (G, T_g, d): group gi * gs + gj holds batch block gi
    and sequence block gj."""
    b, s, d = x.shape
    xg = x.reshape(gb, b // gb, gs, s // gs, d).permute(0, 2, 1, 3, 4)
    return xg.reshape(gb * gs, (b // gb) * (s // gs), d)


def _from_groups(yg: torch.Tensor, gb: int, gs: int, b: int, s: int):
    d = yg.shape[-1]
    y = yg.reshape(gb, gs, b // gb, s // gs, d).permute(0, 2, 1, 3, 4)
    return y.reshape(b, s, d)


def _group_dispatch(xg: torch.Tensor, router: torch.Tensor, cap: int,
                    k: int):
    """Route and dispatch each group of xg (G, T_g, d). Returns the
    buffer (G, E, C, d), the slot maps lin / keep (G, T_g*k), the routing
    weights (G, T_g, k), and the group's expert counts and summed router
    probabilities (E,) for the load-balance loss."""
    e = router.shape[1]
    logits, weights, ids = route(xg, router, k)
    counts = expert_counts(ids.reshape(-1), e).float()
    prob_sum = torch.softmax(logits, dim=-1).sum(dim=(0, 1))
    bufs, lins, keeps = zip(*(dispatch_buffer(xg[i], ids[i], cap, e)
                              for i in range(xg.shape[0])))
    return (torch.stack(bufs), torch.stack(lins), torch.stack(keeps),
            weights, counts, prob_sum)


def _grouped_experts(buf: torch.Tensor, w_gate, w_in, w_out):
    """`expert_ffn` over a (G, E, C, d) buffer: each expert's slots of
    every group in one product. Returns (G, E, C, d)."""
    g, e, c, d = buf.shape
    h = buf.transpose(0, 1).reshape(e, g * c, d)
    out = expert_ffn(h, w_gate, w_in, w_out)
    return out.reshape(e, g, c, d).transpose(0, 1)


def _group_combine(out, lin, keep, weights):
    """`combine` per group: (G, E, C, d) -> (G, T_g, d)."""
    return torch.stack([combine(out[i], lin[i], keep[i], weights[i])
                        for i in range(out.shape[0])])


def _aux(counts, prob_sum, tokens: int, k: int, e: int):
    """Switch-style load-balance loss from the expert counts and summed
    router probabilities over all `tokens` tokens."""
    return ((counts / (tokens * k)) * (prob_sum / tokens)).sum() * e


def _dispatch_gspmd(p, x: torch.Tensor, cfg: ModelConfig):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gb, gs = _num_groups(b, s)
    cap = _capacity((b // gb) * (s // gs), e, k, cfg.capacity_factor)
    if sh.current_mesh() is not None:
        return _dispatch_sharded(p, x, cfg, gb, gs, cap)
    buf, lin, keep, weights, counts, prob_sum = _group_dispatch(
        _to_groups(x, gb, gs), p["router"], cap, k)
    out = _grouped_experts(buf, p["w_gate"], p["w_in"], p["w_out"])
    y = _from_groups(_group_combine(out, lin, keep, weights), gb, gs, b, s)
    return y, _aux(counts, prob_sum, b * s, k, e)


def _dispatch_sharded(p, x, cfg: ModelConfig, gb: int, gs: int, cap: int):
    """The grouped dispatch under a mesh. Each rank holds whole groups:
    batch over the data axes when gb > 1 (else replicated), sequence over
    `model` when gs > 1; so its slab is one group. Region 1 routes and
    dispatches it: the buffer (G, E, C, d) comes out G-major (the
    reference's ``batch_seq_groups`` constraint at `moe.py:151`, on the
    axes that split the groups), is resharded to G over (pod, data) and E
    over `model` (``moe_groups, experts``, `moe.py:153`: an all-to-all
    over `model`), runs the experts on each rank's E/M experts, goes back
    G-major (`moe.py:159`) and region 3 combines each rank's group."""
    mesh = sh.current_mesh()
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    names = mesh.mesh_dim_names
    rep = sh.Replicate()
    # x's placements in the region: whole groups on every rank
    xpl = tuple(sh.Shard(0) if a in ("pod", "data") and gb > 1
                else sh.Shard(1) if a == "model" and gs > 1 else rep
                for a in names)
    gpl = tuple(sh.Shard(0) if isinstance(pl, sh.Shard) else rep
                for pl in xpl)                  # G-major, same split
    sums = tuple(sh.Partial() if isinstance(pl, sh.Shard) else rep
                 for pl in xpl)
    reps = (rep,) * mesh.ndim

    def dispatch(xl, router):
        bl, sl, _ = xl.shape
        return _group_dispatch(xl.reshape(1, bl * sl, d), router, cap, k)
    buf, lin, keep, weights, counts, prob_sum = sh.local_region(
        dispatch, (gpl,) * 4 + (sums, sums), (xpl, reps), mesh)(
            x, p["router"])
    # G-major -> E-major: GShard's dispatch all-to-all
    epl = sh.activation_placements(buf.shape, "moe_groups", "experts",
                                   None, None)
    wpl = tuple(sh.Shard(0) if pl == sh.Shard(1) else rep for pl in epl)
    # an uneven split (40 experts over 16 ranks) keeps its global shape
    out = sh.local_region(_grouped_experts, epl, (epl, wpl, wpl, wpl),
                          mesh, buf.shape)(buf, p["w_gate"], p["w_in"],
                                           p["w_out"])

    local_shape = (b // gb, s // gs, d)

    def combine_local(out, lin, keep, weights):
        return _group_combine(out, lin, keep, weights).reshape(local_shape)
    y = sh.local_region(combine_local, xpl, (gpl,) * 4, mesh)(
        out, lin, keep, weights)
    return y, _aux(counts, prob_sum, b * s, k, e)


def _all_to_all_sharded(p, x, cfg: ModelConfig):
    """`moe_ep.moe_all_to_all` under a mesh, in a `local_map` region over
    the `model` axis's group: x with batch over the data axes and
    sequence over `model`, the router whole, each rank's E/M experts; the
    load-balance loss over every rank of the mesh. Differentiable: the
    region's gradients come back in the inputs' placements (the router's
    summed over the ranks, `local_region`)."""
    from repro_torch.distributed.moe_ep import moe_all_to_all
    mesh = sh.current_mesh()
    names = mesh.mesh_dim_names
    b, s, _ = x.shape
    m = sh.mesh_sizes(mesh)["model"]
    if s % m:
        raise ValueError(f"moe all_to_all: sequence {s} does not divide "
                         f"over the model axis ({m})")
    rep = sh.Replicate()
    xpl = tuple(sh.Shard(1) if a == "model" else
                sh.Shard(0) if a in ("pod", "data") else rep for a in names)
    epl = tuple(sh.Shard(0) if a == "model" else rep for a in names)
    group = mesh["model"].get_group()

    def local(xl, router, wg, wi, wo):
        y, aux = moe_all_to_all({"router": router, "w_gate": wg,
                                 "w_in": wi, "w_out": wo}, xl, cfg, group,
                                aux_group=dist.group.WORLD)
        return y.to(xl.dtype), aux
    return sh.local_region(
        local, (xpl, (rep,) * mesh.ndim),
        (xpl, (rep,) * mesh.ndim, epl, epl, epl), mesh)(
            x, p["router"], p["w_gate"], p["w_in"], p["w_out"])
